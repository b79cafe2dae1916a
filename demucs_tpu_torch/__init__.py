"""demucs_tpu_torch — Demucs v4 (htdemucs) and v3 (hdemucs_mmi) in PyTorch and CUDA.

The PyTorch port of `demucs_tpu`, module for module: each file here has
its counterpart of the same name in the JAX package, which stays the
reference the port is tested against. This package imports neither JAX
nor anything of `demucs_tpu`; it keeps its own copies of what it needs.

Its entry points (`pipeline.Separator`, `cli.main`) run on the GPU
(`device="cuda"`) unless the caller asks for the CPU, and raise when no
GPU is present. v4's attention and v3's BiLSTM recurrence run through
CUDA C++ kernels written for Hopper (`csrc/*.cu`, bound in `ops/cuda/`);
on a CPU tensor the same wrappers run their plain PyTorch versions.

Layout conventions follow `demucs_tpu`:
  * time-branch activations:  (B, C, T)
  * freq-branch activations:  (B, F, C, T) (frequency-major)
  * complex spectrograms:     (B, C, F, T) complex64
"""

__version__ = "0.1.0"
