"""Device telemetry and health assessment.

Reference: ``rustcv-core/src/telemetry.rs:8-73`` — temperature, link
throughput, transmission/drop/corruption counters, power estimate;
``assess_health`` thresholds: temp>85 → Critical(Overheating), temp>75 →
Warning(Overheating), transmission_errors>100 → Warning(HighPacketLoss).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class HealthIssue(enum.Enum):
    OVERHEATING = "overheating"
    BANDWIDTH_SATURATION = "bandwidth_saturation"
    HIGH_PACKET_LOSS = "high_packet_loss"
    SENSOR_ERROR = "sensor_error"


class HealthLevel(enum.Enum):
    HEALTHY = "healthy"
    WARNING = "warning"
    CRITICAL = "critical"


@dataclass(frozen=True)
class DeviceHealthStatus:
    level: HealthLevel
    issue: Optional[HealthIssue] = None

    @property
    def is_healthy(self) -> bool:
        return self.level == HealthLevel.HEALTHY


@dataclass
class DeviceTelemetry:
    temperature_c: Optional[float] = None
    link_throughput_mbps: Optional[int] = None
    transmission_errors: int = 0
    dropped_frames: int = 0
    corrupted_frames: int = 0
    power_consumption_mw: Optional[int] = None

    def assess_health(self) -> DeviceHealthStatus:
        """Thresholds mirror ``telemetry.rs:59-73`` exactly."""
        if self.temperature_c is not None:
            if self.temperature_c > 85.0:
                return DeviceHealthStatus(HealthLevel.CRITICAL, HealthIssue.OVERHEATING)
            if self.temperature_c > 75.0:
                return DeviceHealthStatus(HealthLevel.WARNING, HealthIssue.OVERHEATING)
        if self.transmission_errors > 100:
            return DeviceHealthStatus(HealthLevel.WARNING, HealthIssue.HIGH_PACKET_LOSS)
        return DeviceHealthStatus(HealthLevel.HEALTHY)
