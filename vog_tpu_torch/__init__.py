"""vog_tpu_torch: the PyTorch/CUDA port of vog_tpu for one NVIDIA H100.

Mirrors vog_tpu's layout (config/, data/, sampling/, model/, kernels/,
serve.py, serving.py, train/, evaluation/, cli/, native/, dcode/).  Plain tensor code is PyTorch; every
Pallas TPU kernel, forward and backward, is a hand-written CUDA kernel for
sm_90a (``vog_tpu_torch/csrc``), built with nvcc at first use and bound
with ctypes (``kernels/_build.py``).

The package imports neither JAX nor anything of ``vog_tpu``.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""

from vog_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
