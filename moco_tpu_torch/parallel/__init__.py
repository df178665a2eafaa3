"""Cross-device parts of the port (counterpart of moco_tpu/parallel/)."""
