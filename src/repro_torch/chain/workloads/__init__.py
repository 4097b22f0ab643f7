"""``repro_torch.chain.workloads`` — the application workload suite,
ported from ``repro.chain.workloads``:

* ``SatWorkload`` — §1 "brute-force theorem proving": exhaustive 3-CNF
  decision, with a committed satisfiability certificate that verifiers
  re-check in O(clauses) instead of re-mining (exhaustive refutations
  stay quorum-sampled).
* ``GanInversionWorkload`` — §1 "finding the appropriate input to a
  Generator": stateful optimal-mode latent search; each accepted block
  zooms the grid around the previous winner, verified by replaying the
  round on the verifier's own state.
* ``DockingWorkload`` — the §4 walkthrough, with the data-bundle
  checksum bound into consensus: a peer holding tampered tables
  rejects honest blocks and vice versa.
* ``ModelTrainingWorkload`` — real-model proof-of-useful-work: each
  block is a few training steps of a transformer (``pnpcoin-demo`` by
  default), verified by re-execution on the verifier's own state.

SAT and docking mine in full mode, so every block runs the SHA-256
kernel over its chunks and the Merkle reduction for its commit; a
training block runs the flash-attention forward and backward kernels;
a GAN round evaluates its grid on the card and hashes one leaf on the
host.

``default_suite`` builds one fresh instance of each family
(every node needs its own objects — sharing an instance across nodes
voids independent re-verification, same rule as ``Network.create``);
``WORKLOAD_FAMILIES`` maps family names to classes.
"""
from typing import Dict

from repro_torch.chain.workload import Workload
from repro_torch.chain.workloads.docking import (DockingBundle,
                                                 DockingWorkload)
from repro_torch.chain.workloads.gan import GanInversionWorkload
from repro_torch.chain.workloads.model_train import (MICRO_CONFIG,
                                                     MICRO_KWARGS,
                                                     ModelTrainingWorkload)
from repro_torch.chain.workloads.sat import Cnf3, SatWorkload, random_cnf3
from repro_torch.device import DeviceLike

__all__ = [
    "Cnf3",
    "DockingBundle",
    "DockingWorkload",
    "GanInversionWorkload",
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
    GanInversionWorkload.name: GanInversionWorkload,
    DockingWorkload.name: DockingWorkload,
    ModelTrainingWorkload.name: ModelTrainingWorkload,
}


def default_suite(seed: int = 0, device: DeviceLike = None,
                  **overrides) -> Dict[str, Workload]:
    """Fresh instances of every family, keyed by family name — pass the
    result as ``Node(workloads=...)``.  Call once **per node**: each node
    must own its instances.  ``overrides`` maps a family name to a kwargs
    dict for that family's constructor, e.g.
    ``default_suite(sat={"n_vars": 10})``; naming a family the port does
    not have raises ``ValueError``."""
    unknown = sorted(set(overrides) - set(WORKLOAD_FAMILIES))
    if unknown:
        raise ValueError(
            f"no ported workload family {unknown} (have "
            f"{sorted(WORKLOAD_FAMILIES)})")
    suite: Dict[str, Workload] = {}
    for name, cls in WORKLOAD_FAMILIES.items():
        kwargs = dict(overrides.get(name, ()))
        kwargs.setdefault("seed", seed)
        kwargs.setdefault("device", device)
        suite[name] = cls(**kwargs)
    return suite
