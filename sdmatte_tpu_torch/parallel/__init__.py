"""Training, video and multi-device (sdmatte_tpu/parallel/)."""
