__version__ = "0.2.0"  # the reference's (rustcv_tpu/version.py)
