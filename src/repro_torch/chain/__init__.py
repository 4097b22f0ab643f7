"""``repro_torch.chain`` — the public Node/Network API over the PNPCoin
loop, ported from ``repro.chain``::

    from repro_torch.chain import Node
    node = Node()                     # mines on the CUDA card
    node.submit(my_jash)
    receipt = node.mine_block()

``repro_torch.chain.store`` is the crash-fault layer: ``ChainStore`` is a
durable append-only journal of everything a ``Node(store=...)`` commits,
byte for byte the reference's, and ``Node.recover`` rebuilds a node from
it after a crash (truncating torn/corrupted tails instead of failing).

``TrainingWorkload`` chains ``core.pow_train.PoUWTrainer`` blocks (full
data-parallel SGD or ES search), verified by re-execution on receive.
``repro_torch.chain.workloads`` holds the application families: SAT
(certificate-asymmetric), GAN inversion (stateful latent search), docking
(consensus-bound data bundle) and real-model training.
"""
from repro_torch.chain.network import BroadcastResult, Network
from repro_torch.chain.node import (BlockReceipt, BlockRecord, Node,
                                    NodeState, RecoveryReport, VerifyCache)
from repro_torch.chain.store import (ChainStore, collect_jash_fns,
                                     payload_checksum)
from repro_torch.chain.workload import (
    BlockContext, BlockPayload, ChainError, ClassicSha256Workload,
    JashFullWorkload, JashOptimalWorkload, TrainingWorkload, Workload,
    certificate_digest, verify_chain_batched,
)

__all__ = [
    "BlockContext",
    "BlockPayload",
    "BlockReceipt",
    "BlockRecord",
    "BroadcastResult",
    "ChainError",
    "ChainStore",
    "ClassicSha256Workload",
    "JashFullWorkload",
    "JashOptimalWorkload",
    "Network",
    "Node",
    "NodeState",
    "RecoveryReport",
    "TrainingWorkload",
    "VerifyCache",
    "Workload",
    "certificate_digest",
    "collect_jash_fns",
    "payload_checksum",
    "verify_chain_batched",
]
