"""``repro_torch.chain`` — the public Node/Network API over the PNPCoin
loop, ported from ``repro.chain`` for the full, optimal and classic
workloads::

    from repro_torch.chain import Node
    node = Node()                     # mines on the CUDA card
    node.submit(my_jash)
    receipt = node.mine_block()
"""
from repro_torch.chain.network import BroadcastResult, Network
from repro_torch.chain.node import (BlockReceipt, BlockRecord, Node,
                                    NodeState, VerifyCache)
from repro_torch.chain.workload import (
    BlockContext, BlockPayload, ChainError, ClassicSha256Workload,
    JashFullWorkload, JashOptimalWorkload, Workload, verify_chain_batched,
)

__all__ = [
    "BlockContext",
    "BlockPayload",
    "BlockReceipt",
    "BlockRecord",
    "BroadcastResult",
    "ChainError",
    "ClassicSha256Workload",
    "JashFullWorkload",
    "JashOptimalWorkload",
    "Network",
    "Node",
    "NodeState",
    "VerifyCache",
    "Workload",
    "verify_chain_batched",
]
