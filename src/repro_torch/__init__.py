"""PNPCoin on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

It imports nothing of ``repro`` or JAX. The public surface mirrors the
reference's::

    from repro_torch import Node, Network, Workload

SHA-256 and the Merkle reduction run as hand-written CUDA kernels
(``repro_torch/kernels/csrc``), built with ``nvcc`` at first use.
"""
from repro_torch.chain import BlockRecord, Network, Node, Workload

__all__ = ["BlockRecord", "Network", "Node", "Workload"]
