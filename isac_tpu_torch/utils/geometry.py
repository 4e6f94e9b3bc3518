"""Physical constants the port needs (counterpart of isac_tpu/utils/geometry.py)."""

SPEED_OF_LIGHT = 299792458.0
