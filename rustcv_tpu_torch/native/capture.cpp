// Native host capture layer: synthetic frame generation, pixel-format
// conversion hot loops, and a threaded mmap-style frame ring.
//
// This is the C++ analog of the reference's driver layer:
// - the frame ring mirrors the V4L2 mmap ring + blocking DQBUF contract
//   (rustcv-camera/src/backend/linux/mod.rs:194-237, sys.rs:302-327):
//   a producer thread fills slots at sensor rate, the consumer blocks on
//   dequeue, holds at most `slots-1` buffers, and re-queues; when the
//   consumer lags, frames are dropped and sequence numbers gap.
// - the conversion loops port the reference's integer arithmetic exactly
//   (decode.rs:160-219, videoio/mod.rs:344-399) for the host-side path.
// - the pattern generator implements the same frozen spec as
//   rustcv_tpu_torch/capture/simulation.py (bit-exact).
//
// Exposed through a plain C ABI, bound with ctypes.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

inline uint8_t clamp_u8(int v) { return v < 0 ? 0 : (v > 255 ? 255 : (uint8_t)v); }

// SMPTE-ish bar colors, BGR (must match simulation._BAR_COLORS_BGR).
static const uint8_t BARS[8][3] = {
    {235, 235, 235}, {20, 235, 235}, {235, 235, 20}, {20, 235, 20},
    {235, 20, 235},  {20, 20, 235},  {235, 20, 20},  {20, 20, 20},
};

void pattern_bgr_row(uint8_t* row, int y, int w, int h, long seq, int x0, int sq,
                     int y0) {
  const int gy0 = h * 2 / 3;
  for (int x = 0; x < w; ++x) {
    uint8_t b, g, r;
    if (y >= gy0) {
      int grad = (int)((x + y + seq * 7) % 256);
      b = (uint8_t)grad;
      g = (uint8_t)(255 - grad);
      r = (uint8_t)((grad * 2) % 256);
    } else {
      int bar = x * 8 / (w > 0 ? w : 1);
      if (bar > 7) bar = 7;
      b = BARS[bar][0];
      g = BARS[bar][1];
      r = BARS[bar][2];
    }
    if (y >= y0 && y < y0 + sq && x >= x0 && x < x0 + sq) { b = g = r = 255; }
    row[x * 3 + 0] = b;
    row[x * 3 + 1] = g;
    row[x * 3 + 2] = r;
  }
}

void square_params(int w, int h, long seq, int* x0, int* sq, int* y0) {
  *sq = h / 8 > 4 ? h / 8 : 4;
  int span = w - *sq > 1 ? w - *sq : 1;
  int step = w / 64 > 2 ? w / 64 : 2;
  long pos = (seq * step) % (2 * span);
  *x0 = pos < span ? (int)pos : (int)(2 * span - pos);
  *y0 = h / 2 - *sq / 2 > 0 ? h / 2 - *sq / 2 : 0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Standalone generators / converters
// ---------------------------------------------------------------------------

void rcv_synth_bgr(uint8_t* dst, int w, int h, long seq) {
  int x0, sq, y0;
  square_params(w, h, seq, &x0, &sq, &y0);
  for (int y = 0; y < h; ++y) pattern_bgr_row(dst + (size_t)y * w * 3, y, w, h, seq, x0, sq, y0);
}

// Forward BT.601 (frozen spec, simulation.py bgr_to_yuv_int + encode_yuyv).
void rcv_encode_yuyv(const uint8_t* bgr, uint8_t* dst, int w, int h) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = bgr + (size_t)y * w * 3;
    uint8_t* out = dst + (size_t)y * w * 2;
    for (int x = 0; x < w; x += 2) {
      int b0 = row[x * 3], g0 = row[x * 3 + 1], r0 = row[x * 3 + 2];
      int b1 = row[x * 3 + 3], g1 = row[x * 3 + 4], r1 = row[x * 3 + 5];
      int y0 = ((66 * r0 + 129 * g0 + 25 * b0 + 128) >> 8) + 16;
      int u0 = ((-38 * r0 - 74 * g0 + 112 * b0 + 128) >> 8) + 128;
      int v0 = ((112 * r0 - 94 * g0 - 18 * b0 + 128) >> 8) + 128;
      int y1 = ((66 * r1 + 129 * g1 + 25 * b1 + 128) >> 8) + 16;
      int u1 = ((-38 * r1 - 74 * g1 + 112 * b1 + 128) >> 8) + 128;
      int v1 = ((112 * r1 - 94 * g1 - 18 * b1 + 128) >> 8) + 128;
      y0 = y0 < 0 ? 0 : (y0 > 255 ? 255 : y0);
      y1 = y1 < 0 ? 0 : (y1 > 255 ? 255 : y1);
      u0 = u0 < 0 ? 0 : (u0 > 255 ? 255 : u0);
      u1 = u1 < 0 ? 0 : (u1 > 255 ? 255 : u1);
      v0 = v0 < 0 ? 0 : (v0 > 255 ? 255 : v0);
      v1 = v1 < 0 ? 0 : (v1 > 255 ? 255 : v1);
      out[x * 2 + 0] = (uint8_t)y0;
      out[x * 2 + 1] = (uint8_t)((u0 + u1 + 1) >> 1);
      out[x * 2 + 2] = (uint8_t)y1;
      out[x * 2 + 3] = (uint8_t)((v0 + v1 + 1) >> 1);
    }
  }
}

void rcv_synth_yuyv(uint8_t* dst, int w, int h, long seq) {
  std::vector<uint8_t> bgr((size_t)w * h * 3);
  rcv_synth_bgr(bgr.data(), w, h, seq);
  rcv_encode_yuyv(bgr.data(), dst, w, h);
}

// Inverse BT.601 hot loop — exact port of decode.rs:160-191.
void rcv_yuyv_to_bgr(const uint8_t* src, uint8_t* dst, int w, int h) {
  const long pairs = (long)w * h / 2;
  for (long i = 0; i < pairs; ++i) {
    const uint8_t* s = src + i * 4;
    uint8_t* d = dst + i * 6;
    int y0 = s[0], u = s[1] - 128, y1 = s[2], v = s[3] - 128;
    int c0 = y0 - 16, c1 = y1 - 16;
    d[0] = clamp_u8((298 * c0 + 516 * u + 128) >> 8);
    d[1] = clamp_u8((298 * c0 - 100 * u - 208 * v + 128) >> 8);
    d[2] = clamp_u8((298 * c0 + 409 * v + 128) >> 8);
    d[3] = clamp_u8((298 * c1 + 516 * u + 128) >> 8);
    d[4] = clamp_u8((298 * c1 - 100 * u - 208 * v + 128) >> 8);
    d[5] = clamp_u8((298 * c1 + 409 * v + 128) >> 8);
  }
}

void rcv_bgra_to_bgr(const uint8_t* src, uint8_t* dst, long pixels) {
  for (long i = 0; i < pixels; ++i) {
    dst[i * 3 + 0] = src[i * 4 + 0];
    dst[i * 3 + 1] = src[i * 4 + 1];
    dst[i * 3 + 2] = src[i * 4 + 2];
  }
}

void rcv_rgb_to_bgr(const uint8_t* src, uint8_t* dst, long pixels) {
  for (long i = 0; i < pixels; ++i) {
    dst[i * 3 + 0] = src[i * 3 + 2];
    dst[i * 3 + 1] = src[i * 3 + 1];
    dst[i * 3 + 2] = src[i * 3 + 0];
  }
}

// ---------------------------------------------------------------------------
// Threaded frame ring (V4L2 mmap-ring analog)
// ---------------------------------------------------------------------------

struct Ring {
  int slots = 0;
  long slot_bytes = 0;
  int w = 0, h = 0;
  double fps = 30.0;
  bool paced = true;

  std::vector<std::vector<uint8_t>> buffers;
  std::vector<uint8_t> free_mask;     // 1 = producer may write
  std::deque<int> filled;             // FIFO of filled slot indices
  std::vector<long> slot_seq;
  std::vector<long> slot_ts_ns;

  std::mutex mu;
  std::condition_variable cv;
  std::thread producer;
  std::atomic<bool> running{false};
  std::atomic<long> dropped{0};
  long next_seq = 0;
};

Ring* rcv_ring_create(int slots, int w, int h) {
  Ring* r = new Ring();
  r->slots = slots;
  r->w = w;
  r->h = h;
  r->slot_bytes = (long)w * h * 2;  // YUYV
  r->buffers.assign(slots, std::vector<uint8_t>((size_t)r->slot_bytes));
  r->free_mask.assign(slots, 1);
  r->slot_seq.assign(slots, -1);
  r->slot_ts_ns.assign(slots, 0);
  return r;
}

static void producer_loop(Ring* r) {
  using clock = std::chrono::steady_clock;
  auto start = clock::now();
  long seq = 0;
  while (r->running.load(std::memory_order_relaxed)) {
    if (r->paced) {
      auto due = start + std::chrono::nanoseconds((long)(seq * 1e9 / r->fps));
      std::this_thread::sleep_until(due);
      if (!r->running.load(std::memory_order_relaxed)) break;
    }
    int slot = -1;
    {
      std::lock_guard<std::mutex> lk(r->mu);
      for (int s = 0; s < r->slots; ++s) {
        if (r->free_mask[s]) { slot = s; break; }
      }
    }
    if (slot < 0) {
      // Consumer holds everything: sensor overwrites nothing, frame dropped
      // (sequence gap — the drop-detection signal the benches rely on).
      r->dropped.fetch_add(1, std::memory_order_relaxed);
      ++seq;
      if (!r->paced) std::this_thread::yield();
      continue;
    }
    rcv_synth_yuyv(r->buffers[slot].data(), r->w, r->h, seq);
    long ts = std::chrono::duration_cast<std::chrono::nanoseconds>(clock::now() - start).count();
    {
      std::lock_guard<std::mutex> lk(r->mu);
      r->free_mask[slot] = 0;
      r->slot_seq[slot] = seq;
      r->slot_ts_ns[slot] = ts;
      r->filled.push_back(slot);
    }
    r->cv.notify_one();
    ++seq;
  }
}

int rcv_ring_start(Ring* r, double fps, int paced) {
  if (r->running.load()) return -1;
  r->fps = fps;
  r->paced = paced != 0;
  r->running.store(true);
  r->producer = std::thread(producer_loop, r);
  return 0;
}

void rcv_ring_stop(Ring* r) {
  r->running.store(false);
  r->cv.notify_all();
  if (r->producer.joinable()) r->producer.join();
}

void rcv_ring_destroy(Ring* r) {
  rcv_ring_stop(r);
  delete r;
}

// Blocking dequeue with timeout (ms). Returns slot index ≥ 0, or -1 on
// timeout/stop. Fills *data/*seq/*ts_ns.
long rcv_ring_dequeue(Ring* r, uint8_t** data, long* seq, long* ts_ns, long timeout_ms) {
  std::unique_lock<std::mutex> lk(r->mu);
  bool ok = r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [r] {
    return !r->filled.empty() || !r->running.load();
  });
  if (!ok || r->filled.empty()) return -1;
  int slot = r->filled.front();
  r->filled.pop_front();
  *data = r->buffers[slot].data();
  *seq = r->slot_seq[slot];
  *ts_ns = r->slot_ts_ns[slot];
  return slot;
}

void rcv_ring_requeue(Ring* r, long slot) {
  std::lock_guard<std::mutex> lk(r->mu);
  if (slot >= 0 && slot < r->slots) r->free_mask[(int)slot] = 1;
}

long rcv_ring_dropped(Ring* r) { return r->dropped.load(); }

long rcv_ring_slot_bytes(Ring* r) { return r->slot_bytes; }

}  // extern "C"
