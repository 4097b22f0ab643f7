"""``jax.random``'s threefry2x32 stream, for the draws the reference makes.

The reference draws its token batches (``data/pipeline.py``) and its
initial weights (``models/*.py``) from ``jax.random`` keys. A port node
that trains the same chain must start from the same bits, so this module
computes the same functions, on the device the key lies on:

    key(seed)             -> key (the words of ``jax.random.key(seed)``)
    split(key, num)       -> (num, 2) keys
    fold_in(key, data)    -> key, or keys (*data.shape, 2) for a tensor
    bits(key, shape)      -> uint32 words (as int64)
    randint(key, shape, minval, maxval)  -> int32
    uniform(key, shape, minval, maxval)  -> float32
    bernoulli(key, p, shape)             -> bool
    normal(key, shape)                   -> float32
    normal_concat(keys, sizes)           -> float32, one draw per key

A key is an int64 tensor of shape (2,) holding two 32-bit words. Words
live in int64 and are masked to 32 bits after every operation that can
carry past them, since torch's uint32 lacks shifts, adds and remainders.
``fold_in`` also takes a tensor of data, and ``bits`` and ``normal`` a
batch of keys (..., 2), drawing ``shape`` under each: each row equals the
call on its own key bit for bit, as ``jax.vmap`` of the scalar call
gives. Every draw runs on its key's device (``normal_concat`` on the
device it is given): a model's initial weights and ES noise are drawn on
the card that trains it, where a host draw of qwen3-0.6b's 596M weights
in int64 words would take minutes and tens of GB. The integer words are
the same on every device, but ``normal``'s ``log1p`` may round
differently on another device, so the nodes of one chain draw on the same
kind of device.

The stream is the one JAX draws with ``jax_threefry_partitionable=True``
(the default of the JAX releases the reference's tests run on; older
releases defaulted to False and split and draw bits differently): each
element's counter is its flat index as a 64-bit (hi, lo) pair, and 32
random bits are the xor of threefry's two output words. ``split`` and
every integer draw equal JAX's bit for bit. ``normal`` is
``sqrt(2) * erf_inv(u)`` on the same uniform ``u``; ``erf_inv`` is XLA's
float32 polynomial (M. Giles' approximation), so a value may differ from
JAX's in its last bits where the two libraries' ``log1p`` rounds
differently: over 200,000 draws about 1% of the values differ, by at most
4.8e-7 (``tests/test_torch_train.py`` states the worst it finds).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike

MASK32 = 0xFFFFFFFF
Shape = Union[int, Sequence[int]]
Word = Union[int, torch.Tensor]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1: Word, k2: Word, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds of counter words (x1, x2) under key
    (k1, k2), ints or int64 tensors broadcasting against the counters: the
    two output words, as int64 holding 32 bits."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def _words(key: torch.Tensor) -> Tuple[int, int]:
    if tuple(key.shape) != (2,):
        raise ValueError(f"a key is two words, got shape {tuple(key.shape)}")
    return int(key[0]), int(key[1])


def _batch_words(key: torch.Tensor, ndim: int) -> Tuple[Word, Word]:
    """One key's words as ints, or a batch of keys (..., 2) as int64
    tensors (..., 1 x ndim), to broadcast against the counters of an
    ``ndim``-dim draw."""
    if key.dim() == 1:
        return _words(key)
    if key.shape[-1] != 2:
        raise ValueError(f"keys are (..., 2) words, got shape "
                         f"{tuple(key.shape)}")
    words = key.reshape(*key.shape[:-1], *([1] * ndim), 2)
    return words[..., 0], words[..., 1]


def _counters(shape: Tuple[int, ...], device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each element's flat index as (hi, lo) 32-bit words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (idx >> 32).reshape(shape), (idx & MASK32).reshape(shape)


def key(seed: int) -> torch.Tensor:
    """The words of ``jax.random.key(seed)`` as JAX makes them with 64-bit
    types off (its default): the seed taken as a 32-bit integer, so a high
    word of 0 and the seed's low 32 bits."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: keys of shape ``(*num, 2)``."""
    shape = _shape(num)
    b1, b2 = threefry2x32(*_words(key), *_counters(shape, key.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor,
            data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with ``data``'s low 32 bits
    as the counter (0, data). For an integer tensor of data, keys of shape
    (*data.shape, 2) on its device, each the key of one datum."""
    if isinstance(data, torch.Tensor):
        lo = data.to(torch.int64) & MASK32
        return torch.stack(threefry2x32(*_words(key), torch.zeros_like(lo),
                                        lo), dim=-1)
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(*_words(key), zero, zero + (int(data) & MASK32))
    return torch.cat([b1, b2])


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: uint32 words as int64, of shape
    (*batch, *shape) for keys (*batch, 2)."""
    shape = _shape(shape)
    b1, b2 = threefry2x32(*_batch_words(key, len(shape)),
                          *_counters(shape, key.device))
    return b1 ^ b2


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32, minval <= x < maxval: two words of
    bits an element, reduced modulo the span as JAX does (its small bias
    included)."""
    if not (-2**31 <= minval and maxval <= 2**31 - 1):
        raise ValueError("randint: bounds outside int32")
    shape = _shape(shape)
    k1, k2 = split(key)
    hi, lo = bits(k1, shape), bits(k2, shape)
    span = max(maxval - minval, 1) & MASK32
    mult = (2**16 % span) ** 2 % span
    off = (((hi % span) * mult) & MASK32) + lo % span
    off = (off & MASK32) % span
    return (off + minval).to(torch.int32)


def _unit(words: torch.Tensor) -> torch.Tensor:
    """Floats in [0, 1) from 32 random bits: 23 mantissa bits under
    exponent 0, less one."""
    mant = (words >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def _in_range(unit: torch.Tensor, minval: float,
              maxval: float) -> torch.Tensor:
    lo = torch.tensor(minval, dtype=torch.float32, device=unit.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=unit.device)
    return torch.maximum(lo, unit * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    return _in_range(_unit(bits(key, _shape(shape))), minval, maxval)


def bernoulli(key: torch.Tensor, p: float, shape: Shape) -> torch.Tensor:
    """``jax.random.bernoulli``: a float32 uniform below ``p``."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"):
# coefficients of the polynomial in w - 2.5 where w < 5, in sqrt(w) - 3
# beyond
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: the polynomial's steps as fused
    multiply-adds (the product and sum in float64, rounded once to
    float32), the rest op for op in float32."""
    x = x.float()
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def const(c):
        return torch.tensor(c, dtype=torch.float32, device=x.device)
    p = torch.where(small, const(_ERFINV_SMALL[0]), const(_ERFINV_LARGE[0]))
    for c_small, c_large in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, const(c_small), const(c_large))
        p = (c.double() + p.double() * w.double()).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_of_bits(words: torch.Tensor) -> torch.Tensor:
    """sqrt(2) erf_inv(u), u uniform in (-1, 1) from 32 random bits."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
    u = _in_range(_unit(words), float(lo), 1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32,
                        device=u.device) * erf_inv(u)


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) erf_inv(u) for u uniform
    in (-1, 1); of shape (*batch, *shape) for keys (*batch, 2)."""
    return _normal_of_bits(bits(key, shape))


# elements ``normal_concat`` draws at a time: its int64 words and their
# temporaries stay near a GB whatever the model's size
PIECE = 1 << 24


def normal_concat(keys: torch.Tensor, sizes: Sequence[int],
                  device: DeviceLike = None) -> torch.Tensor:
    """``normal(keys[i], (sizes[i],))`` for each of the (L, 2) keys,
    concatenated into one float32 tensor on ``device`` (each element's
    counter is its index within its own draw). The draws go in passes of
    at most ``PIECE`` elements, as many whole draws a pass as fit, a
    longer draw split over passes; an element's value depends on its key
    and counter alone, so the passes change no bit."""
    dev = torch.device(device) if device is not None else keys.device
    keys = keys.to(dev)
    # (draw, first counter, length) runs of at most PIECE elements, grouped
    # in order into passes of at most PIECE elements
    runs = [(i, lo, min(PIECE, n - lo)) for i, n in enumerate(sizes)
            for lo in range(0, n, PIECE)]
    passes, count = [[]], 0
    for run in runs:
        if passes[-1] and count + run[2] > PIECE:
            passes.append([])
            count = 0
        passes[-1].append(run)
        count += run[2]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    at = 0
    for group in filter(None, passes):
        draw, first, length = (torch.tensor(col, dtype=torch.int64,
                                            device=dev)
                               for col in zip(*group))
        n = sum(r[2] for r in group)
        starts = torch.cumsum(length, 0) - length
        idx = torch.arange(n, dtype=torch.int64, device=dev) - \
            torch.repeat_interleave(starts - first, length, output_size=n)
        k1, k2 = (torch.repeat_interleave(keys[draw, w], length,
                                          output_size=n) for w in (0, 1))
        b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
        out[at:at + n] = _normal_of_bits(b1 ^ b2)
        at += n
    return out
