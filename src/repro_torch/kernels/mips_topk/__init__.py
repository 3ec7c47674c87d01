"""Exact MIPS top-k: hand-written CUDA kernel (``csrc/mips_topk.cu``), its
wrapper (``ops.py``) and its plain PyTorch version (``ref.py``)."""

from repro_torch.kernels.mips_topk.ops import LAUNCHES, mips_topk, reset_launches
from repro_torch.kernels.mips_topk.ref import mips_topk_ref

__all__ = ["LAUNCHES", "mips_topk", "mips_topk_ref", "reset_launches"]
