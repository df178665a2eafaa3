"""PyTorch/CUDA port of moco_tpu, one slice at a time (ROADMAP.md).

Imports torch and numpy only; moco_tpu is the reference it is tested
against. Entry points take `device=` and default to "cuda"."""
