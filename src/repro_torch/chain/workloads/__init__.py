"""``repro_torch.chain.workloads`` — the application workload suite,
ported from ``repro.chain.workloads``:

* ``SatWorkload`` — §1 "brute-force theorem proving": exhaustive 3-CNF
  decision, with a committed satisfiability certificate that verifiers
  re-check in O(clauses) instead of re-mining (exhaustive refutations
  stay quorum-sampled).
* ``DockingWorkload`` — the §4 walkthrough, with the data-bundle
  checksum bound into consensus: a peer holding tampered tables
  rejects honest blocks and vice versa.
* ``ModelTrainingWorkload`` — real-model proof-of-useful-work: each
  block is a few training steps of a transformer (``pnpcoin-demo`` by
  default), verified by re-execution on the verifier's own state.

SAT and docking mine in full mode, so every block runs the SHA-256
kernel over its chunks and the Merkle reduction for its commit; a
training block runs the flash-attention forward and backward kernels.
The reference's ``gan`` family (GAN inversion) is not ported yet
(ROADMAP.md §1, item 3).

``default_suite`` builds one fresh instance of each ported family
(every node needs its own objects — sharing an instance across nodes
voids independent re-verification, same rule as ``Network.create``);
``WORKLOAD_FAMILIES`` maps family names to classes.
"""
from typing import Dict

from repro_torch.chain.workload import Workload
from repro_torch.chain.workloads.docking import (DockingBundle,
                                                 DockingWorkload)
from repro_torch.chain.workloads.model_train import (MICRO_CONFIG,
                                                     MICRO_KWARGS,
                                                     ModelTrainingWorkload)
from repro_torch.chain.workloads.sat import Cnf3, SatWorkload, random_cnf3
from repro_torch.device import DeviceLike

__all__ = [
    "Cnf3",
    "DockingBundle",
    "DockingWorkload",
    "MICRO_CONFIG",
    "MICRO_KWARGS",
    "ModelTrainingWorkload",
    "SatWorkload",
    "WORKLOAD_FAMILIES",
    "default_suite",
    "random_cnf3",
]

# family name -> class. Keys equal each class's ``name`` attribute
# (``Node`` validates that invariant for every registered workload).
WORKLOAD_FAMILIES = {
    SatWorkload.name: SatWorkload,
    DockingWorkload.name: DockingWorkload,
    ModelTrainingWorkload.name: ModelTrainingWorkload,
}

# the reference's families that are not ported yet
_NOT_PORTED = ("gan",)


def default_suite(seed: int = 0, device: DeviceLike = None,
                  **overrides) -> Dict[str, Workload]:
    """Fresh instances of every ported family, keyed by family name —
    pass the result as ``Node(workloads=...)``.  Call once **per node**:
    each node must own its instances.  ``overrides`` maps a family name
    to a kwargs dict for that family's constructor, e.g.
    ``default_suite(sat={"n_vars": 10})``; naming a family the port does
    not have raises ``ValueError``."""
    unknown = sorted(set(overrides) - set(WORKLOAD_FAMILIES))
    if unknown:
        raise ValueError(
            f"no ported workload family {unknown} (have "
            f"{sorted(WORKLOAD_FAMILIES)}; {', '.join(_NOT_PORTED)} is not "
            "ported yet: ROADMAP.md §1, item 3)")
    suite: Dict[str, Workload] = {}
    for name, cls in WORKLOAD_FAMILIES.items():
        kwargs = dict(overrides.get(name, ()))
        kwargs.setdefault("seed", seed)
        kwargs.setdefault("device", device)
        suite[name] = cls(**kwargs)
    return suite
