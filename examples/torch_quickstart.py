"""PNPCoin quickstart on the PyTorch/CUDA port: the complete Fig. 1
pipeline through ``repro_torch.chain``.

A researcher submits the paper's own Collatz example (§3.2) to a
``Node``; each ``mine_block()`` publishes, mines, self-verifies, commits
and rewards one block, falling back to Classic SHA-256 blocks (§3.4)
when the researcher queue empties. The mirror of ``examples/
quickstart.py``: the workloads, result counts, Merkle roots and tip hash
it prints are the same bits.

  PYTHONPATH=src python examples/torch_quickstart.py            # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.chain import Node
from repro_torch.core.jash import Jash, JashMeta, collatz_jash

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device; default: the CUDA card")
device = ap.parse_args().device

node = Node(classic_arg_bits=10, device=device)

# --- researcher submits the paper's Fig. 2->3 Collatz jash ----------------
base = collatz_jash(max_steps=512)
report = node.submit(Jash(base.name, base.fn,
                          JashMeta(arg_bits=10, res_bits=32, importance=0.8,
                                   description="Collatz stopping times"),
                          example_args=base.example_args))
print(f"RA review: compiled={report.compiled} "
      f"runtime={report.runtime_mean_s * 1e3:.2f}ms "
      f"priority={report.priority:.3g}")

# --- three blocks: the queued jash (full mode), then Classic fallback -----
for _ in range(3):
    r = node.mine_block()
    print(f"block {r.record.height}: {r.record.workload.upper():8s} "
          f"{r.record.n_results} results, root={r.record.merkle_root[:16]}… "
          f"mined+verified in {r.block_time_s:.2f}s")

s = node.state()
print(f"\nledger verified: {s.chain_valid}  tip={s.tip_hash[:16]}…")
print(f"credits issued: {s.total_issued} across {len(s.balances)} miners")
