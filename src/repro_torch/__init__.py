"""PyTorch/CUDA port of the CA-RAG system.

Mirrors ``repro``'s subpackages module for module (``core``, ``data``,
``retrieval``, ``serving``, ``kernels``, ``launch``). Tensor code is PyTorch;
the dense-retrieval kernel is hand-written CUDA for Hopper
(``kernels/mips_topk/csrc/mips_topk.cu``).

Device rule: entry points take ``device="cuda"`` by default and raise
``RuntimeError`` when CUDA is unavailable unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
