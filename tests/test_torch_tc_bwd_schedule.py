"""The bf16 backward's item list (``flash_attention_tc_bwd.schedule``),
built on the host for its persistent launch: every item once, heaviest
first, and the tile rule it weighs by against the mask pair by pair. No
card and no JAX: plain numpy."""
import numpy as np
import pytest

from repro_torch.kernels import flash_attention_tc_bwd as ftb

# (B, S, T, H, Kv, causal, window): the train CLI's call, qwen3-0.6b's
# prefill shape, S and T off the 128-row items both ways, GQA 8, windows,
# rows that see no key
SHAPES = [(32, 256, 256, 16, 8, True, 0), (8, 2048, 2048, 16, 8, True, 0),
          (2, 70, 150, 8, 1, False, 0), (1, 150, 70, 4, 2, True, 0),
          (1, 200, 200, 8, 1, True, 64), (1, 100, 40, 2, 1, True, 20),
          (1, 65, 129, 16, 2, False, 33), (2, 192, 320, 16, 2, False, 0),
          (3, 1, 1, 2, 1, True, 0)]


def _band(S, T, causal, window):
    s, t = np.arange(S)[:, None], np.arange(T)[None, :]
    keep = np.ones((S, T), dtype=bool)
    if causal:
        keep &= t <= s
    if window > 0:
        keep &= t > s - window
    return keep


@pytest.mark.parametrize("S, T, causal, window", [
    (1, 1, True, 0), (64, 64, True, 0), (130, 250, True, 45),
    (250, 130, True, 45), (200, 200, False, 64), (100, 40, True, 20),
    (65, 129, False, 33), (300, 300, True, 1)])
def test_visible_tiles_match_the_mask_pair_by_pair(S, T, causal, window):
    keep = _band(S, T, causal, window)
    pad = np.zeros((-(-S // 64) * 64, -(-T // 64) * 64), dtype=bool)
    pad[:S, :T] = keep
    want = pad.reshape(pad.shape[0] // 64, 64, pad.shape[1] // 64,
                       64).any(axis=(1, 3))
    assert np.array_equal(ftb.visible_tiles(S, T, causal, window), want)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_lists_every_item_once_heaviest_first(shape, rows):
    B, S, T, H, Kv, causal, window = shape
    items = ftb.schedule(B, S, T, H, Kv, causal, window, rows)
    assert items.dtype == np.int32 and items.shape[1] == 2
    kind, tile = items[:, 0] & 1, items[:, 0] >> 1
    y = items[:, 1].view(np.uint32)
    head, row = y & 0xFFFF, y >> 16
    got = sorted(zip(kind.tolist(), tile.tolist(), row.tolist(),
                     head.tolist()))
    n_kv, n_q = -(-T // rows), -(-S // rows)
    want = sorted([(0, i, b, h) for i in range(n_kv) for b in range(B)
                   for h in range(Kv)] +
                  [(1, i, b, h) for i in range(n_q) for b in range(B)
                   for h in range(H)])
    assert got == want
    # an item's weight: 4 products for each 64 x 64 tile (times the
    # group's heads) a dK/dV warpgroup computes, 3 for each a dQ one does
    vis = ftb.visible_tiles(S, T, causal, window)
    per, G = rows // 64, H // Kv

    def weight(k, i):
        tiles = range(i * per, (i + 1) * per)
        if k == 0:
            return 4 * G * sum(int(vis[:, t].sum()) for t in tiles
                               if t < vis.shape[1])
        return 3 * sum(int(vis[t].sum()) for t in tiles if t < vis.shape[0])
    cache = {}
    weights = [cache.setdefault((k, i), weight(k, i))
               for k, i in zip(kind.tolist(), tile.tolist())]
    assert all(a >= b for a, b in zip(weights, weights[1:]))
