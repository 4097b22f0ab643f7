#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

On one CUDA card it:
  1. reports the card, its power limit and the software, and builds the
     hand-written kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
  2. holds each kernel against its plain PyTorch version on the card: the
     hash kernels exactly (integer work) and against hashlib, flash
     attention within 2e-4 (float32) and 2e-2 (bfloat16) over head dims,
     GQA groups, causal or not and ragged lengths; then times kernels,
     plain versions and, for attention, PyTorch's SDPA as a yardstick, at
     the main paths' shapes;
  3. drives the mining path through ``Node`` at full size: a collatz jash
     over 2**20 args mined as a full block, then as an optimal block, then
     a Classic double-SHA-256 block over 2**20 nonces, each self-verified,
     then the node's own audit of its chain;
  4. runs a 2-node ``Network`` to convergence;
  5. serves qwen3-0.6b at full width through ``repro_torch.launch.serve``
     (batch 8, prompt 2048, 32 new tokens, bf16, random weights from a
     fixed seed) and holds the first and last layers' attention against
     the plain version; a reduced float32 model served on the card and on
     the CPU must agree;
  6. checks each kernel's launch count from its own path and that the
     verifier's hashlib fallback never fired, and prints the kernel table.
Each phase prints one JSON line. The last line is the result. Any failure
raises and exits non-zero; without a card the script exits non-zero before
printing any result.
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# 32-bit instructions one SHA-256 compression needs, counted as sm_90 runs
# them: a rotate or shift is one funnel shift, a three-input xor, Ch or Maj
# is one LOP3, and up to three summands are one IADD3. A round is 6
# rotates, 4 LOP3 and 4 IADD3 (h + S1 + Ch + K + W takes two, the new e and
# a one each); a schedule step is 4 shifts, 2 LOP3 and 2 IADD3; then come
# the 8 final adds. The Merkle parent's second compression reads K + W from
# a table and has no schedule. A byte swap on load is one PRMT per word.
OPS_ROUND, OPS_SCHEDULE = 14, 10
OPS_COMPRESSION = 64 * OPS_ROUND + 48 * OPS_SCHEDULE + 8
OPS_PAD_COMPRESSION = 64 * OPS_ROUND + 8
WORD_BYTES = 4      # a word is 32 bits, whatever the tensor holding it
# H100 SXM: 3.35 TB/s of HBM3. Instructions: 132 SMs x 4 schedulers x 32
# lanes x 1.98 GHz, the issue rate behind the data sheet's 67 TFLOP/s in
# float32 (an FMA counts as two flops). Integer adds also issue to the FMA
# pipe as IMAD, so the 64 INT32 lanes of an SM are not the limit.
HBM_BYTES_S = 3.35e12
ISSUE_OPS_S = 132 * 128 * 1.98e9
# dense bf16 tensor-core peak (data sheet): the peak rate for attention's
# bf16 inputs, whichever units a kernel uses
BF16_FLOPS_S = 989e12

# serve shape: qwen3-0.6b, batch 8, prompt 2048, 32 new tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}

MAIN_BITS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ISSUE_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else \
        "operations"


def kernel_name(mangled: str) -> str:
    """A readable name for a kernel's mangled symbol: the function and its
    template arguments."""
    import re
    found = re.search(r"(sha256_rows_kernel|merkle_level_kernel|"
                      r"flash_fwd_kernel)", mangled)
    check(found is not None, f"known kernel name in {mangled}")
    name = found[1]
    flags = re.search(r"ILb(\d)ELb(\d)E", mangled)
    if flags:
        name += f"<raw={flags[1]},bswap={flags[2]}>"
    targs = re.search(r"I(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if targs:
        name += f"<{'f32' if targs[1] == 'f' else 'bf16'},hd={targs[2]}>"
    return name


def ptxas_usage(log: str) -> dict:
    """Registers, barriers and spills of each kernel, from ``-Xptxas -v``."""
    import re
    usage, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = kernel_name(entry[1])
        elif name and ("registers" in line or "spill" in line):
            usage.setdefault(name, []).append(
                line.split(":", 1)[-1].strip())
    return usage


def sass_counts(lib: Path) -> dict:
    """Instructions of each kernel in the built library, read from its SASS
    with cuobjdump (the SASS is kept beside the library): the total, without
    NOPs, and each opcode that occurs at least 8 times."""
    import os
    import re
    import shutil
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") \
        / "bin" / "cuobjdump"
    exe = str(tool) if tool.exists() else shutil.which("cuobjdump")
    check(exe is not None, "cuobjdump found")
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    lib.with_suffix(".sass").write_text(text)
    ops, name = {}, None
    for line in text.splitlines():
        func = re.match(r"\s*Function : (\S+)", line)
        if func:
            name = kernel_name(func[1])
            ops[name] = {}
            continue
        insn = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
            line)
        if insn and name and insn[1] != "NOP":
            ops[name][insn[1]] = ops[name].get(insn[1], 0) + 1
    check(len(ops) == 10, f"ten kernels in the library, found {list(ops)}")
    return {name: {"instructions": sum(c.values()),
                   "opcodes": {k: v for k, v in sorted(
                       c.items(), key=lambda kv: -kv[1]) if v >= 8}}
            for name, c in ops.items()}


def cuda_ms(fn, reps=10):
    """Median of ``reps`` timed calls, CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_vs_plain(dev) -> dict:
    """The flash kernel against its plain version: head dims 32, 64, 128;
    GQA groups 1 and 2; causal and not; S = T in {33, 1000, 2048} and
    S != T; float32 and bfloat16; and the large equal-score case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(20261)
    cases = [(hd, g, causal, n, n) for hd in (32, 64, 128) for g in (1, 2)
             for causal in (True, False) for n in (33, 1000, 2048)]
    cases += [(hd, 2, False, 700, 1500) for hd in (32, 64, 128)]
    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol, worst = FLASH_TOL[name], 0.0
        for hd, g, causal, n_q, n_k in cases:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            q, k, v = randn(2, n_q, 2 * g, hd), randn(2, n_k, 2, hd), \
                randn(2, n_k, 2, hd)
            got = flash_attention_cuda(q, k, v, causal=causal).float()
            want = ref.flash_attention_ref(q, k, v, causal=causal).float()
            worst = max(worst, float((got - want).abs().max()))
            check(torch.allclose(got, want, rtol=tol, atol=tol),
                  f"flash {name} hd={hd} G={g} causal={causal} S={n_q} "
                  f"T={n_k} vs plain")
        max_err[name] = worst
    q = torch.full((1, 32, 1, 32), 30.0, device=dev)
    out = flash_attention_cuda(q, q.clone(), torch.ones_like(q), causal=True)
    check(bool(torch.isfinite(out).all()) and torch.allclose(
        out, torch.ones_like(out), rtol=1e-5, atol=0),
        "flash large equal scores give 1")
    return {"cases": 2 * len(cases) + 1, "max_abs_err": max_err,
            "tolerance": FLASH_TOL, "stability_equal_scores": True}


def flash_times(dev) -> dict:
    """Kernel, plain version and SDPA (the yardstick, never on the path)
    at the serve shape, and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    B, S, H, Kv, hd = SERVE_BATCH, SERVE_PROMPT, 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(20262)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, Kv, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, Kv, hd, generator=gen, device=dev).bfloat16()
    out = flash_attention_cuda(q, k, v, causal=True)
    check(torch.equal(out, flash_attention_cuda(q, k, v, causal=True)),
          "flash kernel equal from run to run")
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    check(torch.allclose(sdpa().transpose(1, 2).float(), out.float(),
                         rtol=2e-2, atol=2e-2), "SDPA agrees with the kernel")
    library_ms = cuda_ms(sdpa)
    # 4 hd flops per (query, key) pair (QK^T and PV, an FMA as two), over
    # the S (S + 1) / 2 causal pairs of each (b, h), at the bf16 peak; the
    # bytes of q, k, v and out, each once, at the HBM rate
    pairs = S * (S + 1) // 2
    flops = 4 * hd * pairs * B * H
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = flops / BF16_FLOPS_S, nbytes / HBM_BYTES_S
    return {"shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} bf16 causal",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_arithmetic": f"max({flops:.4g} flops / 989e12, "
                                f"{nbytes:.4g} B / 3.35e12) = "
                                f"max({t_ops * 1e3:.4g}, "
                                f"{t_bytes * 1e3:.4g}) ms",
            "tflops_per_s": flops / (ms * 1e-3) / 1e12}


def serve_phase(dev) -> dict:
    """The serving path at full width through ``repro_torch.launch.serve``,
    with the launch counts read around it; then a warm run timed, with the
    attention launches of its prefill timed by CUDA events; then a reduced
    float32 model served on the card and on the CPU from the same
    weights."""
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import flash_attention, merkle, ops, ref, sha256
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    cfg = get_config("qwen3-0.6b")
    real = ops.flash_attention
    seen = []     # (q, k, v, out) of the first and the latest layer

    def recording(q, k, v, *, causal):
        out = real(q, k, v, causal=causal)
        seen[1 if seen else 0:] = [(q, k, v, out)]   # keep first, last
        return out

    argv = ["--arch", cfg.name, "--reduced", "0", "--batch",
            str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT),
            "--new-tokens", str(SERVE_NEW)]
    ops.flash_attention = recording
    sha256.launches = merkle.launches = flash_attention.launches = 0
    try:
        res = serve.main(argv)
        torch.cuda.synchronize()
    finally:
        ops.flash_attention = real
    counts = {"sha256": sha256.launches, "merkle": merkle.launches,
              "flash_attention": flash_attention.launches}
    check(counts["flash_attention"] == cfg.n_layers,
          f"one flash launch per prefill layer, got {counts}")
    check(res.tokens.shape == (SERVE_BATCH, SERVE_NEW), "generated shape")
    check(int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size, "token ids in vocab")
    check(bool(torch.isfinite(res.last_logits).all()), "logits finite")
    check(res.last_logits.shape == (SERVE_BATCH, 1, cfg.padded_vocab),
          "logits shape")
    layer_err = []
    for q, k, v, out in seen:
        want = ref.flash_attention_ref(q, k, v, causal=True).float()
        layer_err.append(float((out.float() - want).abs().max()))
        check(torch.allclose(out.float(), want, rtol=FLASH_TOL["bfloat16"],
                             atol=FLASH_TOL["bfloat16"]),
              "serve layer attention vs plain")
        del want
    check(len(seen) == 2, "first and last layer recorded")
    del seen[:]
    first = {"prefill_ms": res.prefill_s * 1e3,
             "decode_ms_per_token": res.decode_s_per_token * 1e3,
             "tokens_row0": res.tokens[0].tolist()}
    del res
    torch.cuda.empty_cache()

    # warm run: the same serve call, its prefill's attention timed
    events = []

    def timed(q, k, v, *, causal):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(q, k, v, causal=causal)
        end.record()
        events.append((start, end))
        return out

    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention = timed
    try:
        warm = serve.serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                           new_tokens=SERVE_NEW, device=dev)
        torch.cuda.synchronize()
    finally:
        ops.flash_attention = real
    check(warm.tokens[0].tolist() == first["tokens_row0"],
          "warm run generates the same tokens")
    check(len(events) == cfg.n_layers, "warm prefill: one launch a layer")
    timing = {"warm_prefill_ms": warm.prefill_s * 1e3,
              "warm_attention_ms_in_prefill": sum(
                  a.elapsed_time(b) for a, b in events),
              "warm_decode_ms_per_token": warm.decode_s_per_token * 1e3,
              "warm_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del warm
    torch.cuda.empty_cache()

    # a small float32 model: the card against the CPU on the same weights
    small = reduced(cfg)
    params = build_model(small).init(torch.Generator().manual_seed(1))

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}
    kw = dict(batch=2, prompt_len=100, new_tokens=8, seed=1)
    on_card = serve.serve(small, device=dev, params=to(params, dev), **kw)
    on_cpu = serve.serve(small, device="cpu", params=params, **kw)
    small_err = float((on_card.last_logits.cpu() - on_cpu.last_logits)
                      .abs().max())
    check(torch.equal(on_card.tokens.cpu(), on_cpu.tokens),
          "reduced model: card and CPU tokens equal")
    check(small_err <= 1e-4, f"reduced model: logits within 1e-4 "
                             f"({small_err})")
    return {"phase": "serve", "arch": cfg.name, "batch": SERVE_BATCH,
            "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
            "dtype": cfg.dtype, "counts": counts, **first, **timing,
            "layer_attention_max_abs_err": layer_err,
            "reduced_card_vs_cpu_max_abs_err": small_err}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.chain import Network, Node
    from repro_torch.core import verify
    from repro_torch.core.jash import Jash, JashMeta, collatz_jash
    from repro_torch.core.ledger import merkle_root
    from repro_torch.kernels import flash_attention, merkle, native, ref, \
        sha256

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20260)

    def words(*shape):
        return torch.randint(0, 2**32, shape, generator=gen, device=dev,
                             dtype=torch.int64)

    # -- 1. environment and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib, log = native.build()
    native.library()
    build_s = time.perf_counter() - t0
    emit({"phase": "environment", "gpu": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "ptxas": ptxas_usage(log), "sass": sass_counts(lib),
          "counted_ops": {"compression": OPS_COMPRESSION,
                          "merkle_parent": OPS_COMPRESSION
                          + OPS_PAD_COMPRESSION}})

    # -- 2. kernels vs plain versions ----------------------------------------
    sha_rows, max_err = [], {"sha256": 0, "merkle": 0}
    # (N, W, raw, bswap): both digests at 2**22 rows, then each kernel
    # instantiation with one output at the shapes the main path gives it
    # (Classic: raw at W = 2 and W = 8; the audit's leaf digests: bswap).
    sha_cases = [(1 << 22, w, True, True) for w in (1, 2, 9, 13, 16, 20)]
    sha_cases += [(1 << 20, 2, True, False), (1 << 20, 8, True, False),
                  (1 << 20, 2, False, True)]
    for n, w, want_r, want_b in sha_cases:
        msg = words(n, w)
        got = sha256.sha256_rows_cuda(msg, raw=want_r, bswap=want_b)
        check((got[0] is not None) == want_r and (got[1] is not None)
              == want_b, f"sha256 outputs asked for at W={w}")
        for out, swap in zip(got, (False, True)):
            if out is None:
                continue
            what = f"sha256 raw={want_r} bswap={want_b} W={w}, " + \
                ("bswap" if swap else "raw") + " digest"
            src = ref.bswap32(msg) if swap else msg
            err = int((out - ref.sha256_words_ref(src)).abs().max())
            max_err["sha256"] = max(max_err["sha256"], err)
            check(err == 0, what + " vs plain")
            check(np.array_equal(
                out[:1000].cpu().numpy(),
                ref.sha256_words_hashlib(src[:1000].cpu().numpy())),
                what + " vs hashlib")
        sha_rows.append({"n": n, "w": w, "raw": want_r, "bswap": want_b,
                         "equal": True})
        del msg, got, out, src

    def plain_reduce(rows):
        while rows.shape[2] > merkle._CUTOVER:
            rows = merkle._node_hash_ref(rows)
        return rows

    digests = words(1 << 22, 8)
    rows = digests.T.reshape(8, 1, -1).contiguous()
    top = merkle._reduce(rows, keep_levels=False)[-1]
    err = int((top - plain_reduce(rows)).abs().max())
    max_err["merkle"] = err
    check(err == 0, "merkle kernel vs plain on 2**22 leaves")
    d_np = digests.cpu().numpy().astype(np.uint32)
    root_22 = merkle.merkle_root_from_digests(d_np, device=dev)

    def hashlib_root(d):
        level = [row.astype(">u4").tobytes() for row in d]
        while len(level) > 1:
            if len(level) % 2:
                level.append(level[-1])
            buf = b"".join(level)
            level = [hashlib.sha256(buf[i:i + 64]).digest()
                     for i in range(0, len(buf), 64)]
        return level[0].hex()

    check(merkle.merkle_root_from_digests(d_np[:1 << 16], device=dev)
          == hashlib_root(d_np[:1 << 16]), "merkle 2**16 root vs hashlib")
    forest = d_np[:4 << 16].reshape(4, 1 << 16, 8)
    forest_rows = torch.from_numpy(np.ascontiguousarray(
        forest.transpose(2, 0, 1)).astype(np.int64)).to(dev)
    check(torch.equal(merkle._reduce(forest_rows, False)[-1],
                      plain_reduce(forest_rows)),
          "merkle forest kernel vs plain")
    check(merkle.merkle_roots_from_digests(forest, device=dev)
          == [hashlib_root(t) for t in forest], "merkle forest vs hashlib")
    flash = flash_vs_plain(dev)
    emit({"phase": "flash_vs_plain", **flash})
    max_err["flash_attention"] = max(flash["max_abs_err"].values())
    emit({"phase": "kernels_vs_plain", "sha256": sha_rows,
          "merkle": {"leaves": 1 << 22, "root": root_22, "equal": True,
                     "hashlib_2_16": True, "forest": "4 x 2**16"},
          "flash_attention": {"cases": flash["cases"], "within_tolerance":
                              True, "tolerance": FLASH_TOL},
          "max_abs_err": max_err})

    # timing at the main path's shapes
    def sha_case(n, w, raw, bswap):
        msg = words(n, w)
        nb = (w * 32 + 1 + 64 + 511) // 512
        outs = int(raw) + int(bswap)
        ms = cuda_ms(lambda: sha256.sha256_rows_cuda(msg, raw=raw,
                                                     bswap=bswap))

        def plain():
            if raw:
                ref.sha256_words_ref(msg)
            if bswap:
                ref.sha256_words_ref(ref.bswap32(msg))
        plain_ms = cuda_ms(plain, reps=3)
        b, by = bound_ms(WORD_BYTES * n * (w + 8 * outs),
                         n * nb * outs * OPS_COMPRESSION + bswap * n * w)
        return {"shape": f"N={n} W={w} raw={raw} bswap={bswap}", "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                "msgs_per_s": n / (ms * 1e-3)}

    sha_times = [sha_case(1 << 16, 2, True, True),     # full-mode chunk
                 sha_case(1 << 20, 2, True, False),    # classic, hash 1
                 sha_case(1 << 20, 8, True, False)]    # classic, hash 2
    leaves = 1 << MAIN_BITS
    mrows = words(8, 1, leaves)
    parents, width = 0, leaves
    while width > merkle._CUTOVER:
        width = (width + 1) // 2
        parents += width
    m_ms = cuda_ms(lambda: merkle._reduce(mrows, False))
    m_plain = cuda_ms(lambda: plain_reduce(mrows), reps=3)
    m_bound, m_by = bound_ms(WORD_BYTES * 8 * (leaves + width),
                             parents * (OPS_COMPRESSION + OPS_PAD_COMPRESSION))
    merkle_time = {"shape": f"(8, 1, {leaves}) -> width {width}",
                   "ms": m_ms, "plain_ms": m_plain, "bound_ms": m_bound,
                   "bound_by": m_by, "nodes_per_s": parents / (m_ms * 1e-3)}
    flash_time = flash_times(dev)
    emit({"phase": "flash_times", "gpu": smi, **flash_time})
    emit({"phase": "kernel_times", "gpu": smi, "sha256": sha_times,
          "merkle": merkle_time, "flash_attention": flash_time})
    del digests, rows, top, forest_rows, mrows
    torch.cuda.empty_cache()

    # -- 3. the main path at full size -------------------------------------
    sha256.launches = merkle.launches = flash_attention.launches = 0
    verify.hashlib_fallbacks = 0
    node = Node(device="cuda", classic_arg_bits=MAIN_BITS)
    # host-clock split of each block into the workload's three steps
    split = {name: {} for name in node.workloads}
    for name, wl in node.workloads.items():
        for step in ("mine", "verify", "reward"):
            def timed(*args, _orig=getattr(wl, step), _name=name, _step=step):
                t = time.perf_counter()
                out = _orig(*args)
                torch.cuda.synchronize()
                split[_name][_step + "_s"] = time.perf_counter() - t
                return out
            setattr(wl, step, timed)
    base = collatz_jash(max_steps=512)
    job = Jash(base.name, base.fn,
               JashMeta(arg_bits=MAIN_BITS, res_bits=32, importance=0.8,
                        description="Collatz stopping times"),
               example_args=base.example_args)
    t = time.perf_counter()
    review = node.submit(job)
    review_s = time.perf_counter() - t
    emit({"phase": "review", "jash_id": review.jash_id, "review_s": review_s,
          "runtime_mean_s": review.runtime_mean_s,
          "flops_estimate": review.flops_estimate})
    receipts = [node.mine_block()]
    node.submit(job)
    receipts.append(node.mine_block("optimal"))
    receipts.append(node.mine_block())
    for r in receipts:
        rec = r.record
        emit({"phase": "block", "workload": rec.workload,
              "height": rec.height, "n_results": rec.n_results,
              "root": rec.merkle_root, "winner": rec.winner,
              "block_time_s": r.block_time_s, **split[rec.workload]})
    t = time.perf_counter()
    audited = node.audit_chain()
    audit_s = time.perf_counter() - t
    torch.cuda.synchronize()
    counts = {"sha256": sha256.launches, "merkle": merkle.launches,
              "flash_attention": flash_attention.launches,
              "hashlib_fallbacks": verify.hashlib_fallbacks}

    full, opt, classic = (r.payload for r in receipts)
    check([r.record.workload for r in receipts]
          == ["full", "optimal", "classic"], "block workloads")
    check(full.n_results == opt.n_results == classic.n_results == 1 << 20,
          "blocks cover 2**20 args")
    check(audited and node.state().chain_valid, "node audits its chain")
    f = full.full
    check(f.results.shape == (1 << 20, 1) and f.results.dtype == np.uint32,
          "full results shape")

    def collatz_u32(a, steps=512):
        b, n = max(a, 1), 0
        while b != 1 and n < steps:
            b = b // 2 if b % 2 == 0 else (3 * b + 1) & 0xFFFFFFFF
            n += 1
        return n if b == 1 else steps

    probe = list(range(1024)) + [159487, 212649, 239231, 270271, 288615]
    check(all(int(f.results[a, 0]) == collatz_u32(a) for a in probe),
          "collatz results vs Python, including args that wrap past 2**32")
    idx = np.random.RandomState(0).choice(1 << 20, 1000, replace=False)
    leaves_b = [f.merkle_leaves[i] for i in idx]
    check(all(f.leaf_digests[i].astype(">u4").tobytes()
              == hashlib.sha256(lf).digest() for i, lf in zip(idx, leaves_b)),
          "leaf digests vs hashlib")
    check(all(f.hashes[i].astype(">u4").tobytes()
              == hashlib.sha256(f.packed_words()[i].astype(">u4").tobytes())
              .digest() for i in idx), "submission hashes vs hashlib")
    check(full.merkle_root == merkle_root(list(f.merkle_leaves),
                                          backend="hashlib"),
          "full-block root vs hashlib")
    first = int(np.argmin(f.results[:, 0]))
    check(opt.best_arg == first
          and opt.best_res == f.results[first].tobytes().hex(),
          "optimal block = argmin of results")
    nonce_msg = int(classic.best_arg).to_bytes(4, "big") + b"PNPC"
    double = hashlib.sha256(hashlib.sha256(nonce_msg).digest()).digest()
    check(bytes.fromhex(classic.best_res) == np.frombuffer(
        double, ">u4").astype("<u4").tobytes(), "classic best_res vs hashlib")
    emit({"phase": "main_path", "audit_chain_s": audit_s,
          "counts": counts, "checks": "passed"})

    # -- 4. network ----------------------------------------------------------
    net = Network.create(2, classic_arg_bits=16, device="cuda")
    small = Jash(base.name, base.fn,
                 JashMeta(arg_bits=16, res_bits=32, importance=0.8),
                 example_args=base.example_args)
    t = time.perf_counter()
    for i, wl in enumerate(["full", "optimal", None, None]):
        if wl is not None:
            net.nodes[i % 2].submit(small)
        res = net.mine(origin=i % 2, workload=wl)
        check(not res.rejected_by, f"peers rejected block {i}")
    books = {tuple(sorted(n.book.balances.items())) for n in net.nodes}
    check(net.converged() and len(books) == 1, "network converged")
    emit({"phase": "network", "nodes": 2, "blocks": 4,
          "height": net.heights, "tip": net.tips[0],
          "seconds": time.perf_counter() - t})

    # -- 5. serving qwen3-0.6b at full width ----------------------------------
    served = serve_phase(dev)
    emit(served)

    # -- 6. launch counts and the kernel table -------------------------------
    check(counts["sha256"] > 0 and counts["merkle"] > 0,
          "both hash kernels launched on the mining path")
    check(served["counts"]["flash_attention"] > 0,
          "flash attention launched on the serving path")
    check(counts["hashlib_fallbacks"] == 0, "hashlib fallback never fired")
    chunk = sha_times[0]
    emit({"kernels": [
        {"name": "sha256_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sha256.cu",
         "replaces": "src/repro/kernels/sha256.py:34",
         "launches": counts["sha256"], "max_abs_err": max_err["sha256"],
         "ms": chunk["ms"], "plain_ms": chunk["plain_ms"],
         "bound_ms": chunk["bound_ms"], "bound_by": chunk["bound_by"],
         "library_ms": None, "shape": chunk["shape"], "matched": True},
        {"name": "merkle_level", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/merkle.cu",
         "replaces": "src/repro/kernels/merkle.py:132",
         "launches": counts["merkle"], "max_abs_err": max_err["merkle"],
         "ms": merkle_time["ms"], "plain_ms": merkle_time["plain_ms"],
         "bound_ms": merkle_time["bound_ms"],
         "bound_by": merkle_time["bound_by"], "library_ms": None,
         "shape": merkle_time["shape"], "matched": True},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:28",
         "launches": served["counts"]["flash_attention"],
         "max_abs_err": max_err["flash_attention"],
         "ms": flash_time["ms"], "plain_ms": flash_time["plain_ms"],
         "bound_ms": flash_time["bound_ms"],
         "bound_by": flash_time["bound_by"],
         "library_ms": flash_time["library_ms"],
         "shape": flash_time["shape"], "matched": True},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
