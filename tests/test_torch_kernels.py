"""The port's kernel plain versions against the JAX package's oracles, and
(on a card) the CUDA kernels against the plain versions.

Inputs are numpy arrays from ``np.random.default_rng``; the JAX side runs
as ``tests/test_kernels.py`` runs it (Pallas in interpret mode, or the XLA
path that is the kernels' oracle)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ComplexityConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MIN_SPLIT_ROWS, decode_attention_cuda, decode_attention_paged_cuda,
    decode_attention_paged_plain, decode_attention_split_plain,
    lean_instance, plan_blocks, plan_split_rows, split_rows_for)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BLOCK_K, BLOCK_Q, _tile_range, blocks_per_sm, flash_attention_cuda,
    flash_attention_plain, flash_attention_tiled_plain, kernel_of)
from repro_torch.kernels.image_complexity import (  # noqa: E402
    SCORE_KEYS, image_complexity_cuda, image_stats_banded_plain,
    image_stats_cuda, image_stats_grid, image_stats_plain)

ATOL = RTOL = 2e-5


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# image statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(16, 16), (33, 65), (64, 128), (128, 96)])
def test_image_stats_plain_matches_jax(h, w):
    # integer-valued pixels keep every stencil value an integer, so the f32
    # sums of both frameworks are exact whatever their summation order
    imgs = np.random.default_rng(h * w).integers(0, 256, (2, h, w)).astype(
        np.float32)
    got = tref.image_stats_batch_ref(torch.as_tensor(imgs))
    for want in (jops.image_stats(jnp.asarray(imgs), interpret=True),
                 jref.image_stats_batch_ref(jnp.asarray(imgs))):
        np.testing.assert_array_equal(got["hist"].numpy(), _np(want["hist"]))
        for k in ("sobel_sum", "lap_sum", "lap_sq_sum"):
            np.testing.assert_allclose(got[k].numpy(), _np(want[k]),
                                       rtol=2e-5, atol=1e-3)


def test_image_stats_single_ref_and_wrapper_on_cpu():
    imgs = np.random.default_rng(3).uniform(0, 255, (3, 40, 56)).astype(
        np.float32)
    x = torch.as_tensor(imgs)
    before = tops.image_stats.launches
    batch = tops.image_stats(x)  # CPU tensor -> plain version, no launch
    assert tops.image_stats.launches == before
    one = tref.image_stats_ref(x[1])
    for k in batch:
        np.testing.assert_allclose(one[k].numpy(), batch[k][1].numpy(),
                                   rtol=1e-6)
    np.testing.assert_array_equal(batch["hist"].sum(-1).numpy(), 40 * 56)


@pytest.mark.parametrize("seed", [0, 1])
def test_image_complexity_scores_match_jax(seed):
    from repro.data.synthetic import make_image

    rng = np.random.default_rng(seed)
    imgs = np.stack([make_image(rng, u, 48, 64) for u in (0.1, 0.5, 0.9)])
    cc = ComplexityConfig()
    want = jops.image_complexity(jnp.asarray(imgs), cc, interpret=True)
    got = tops.image_complexity(torch.as_tensor(imgs), cc)
    for k in ("c_res", "c_edge", "c_ent", "c_lap", "c_img"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=0,
                                   atol=1e-6)


# (shape, rows per band, fill): degenerate images, a ragged last band (33
# rows in bands of 8, 7 in bands of 3), unaligned rows (W=65), the grid's
# own band height (None), and a flat image (every pixel in one bin)
BANDED_CASES = {
    "1x1": ((1, 1, 1), 1, None),
    "1x7": ((1, 1, 7), 1, None),
    "7x1 ragged": ((1, 7, 1), 3, None),
    "33x65 ragged": ((2, 33, 65), 8, None),
    "33x65 one band": ((2, 33, 65), None, None),
    "128x96 bands of 16": ((3, 128, 96), 16, None),
    "128x96 bands of 5": ((3, 128, 96), 5, None),
    "flat 255": ((1, 64, 64), 8, 255.0),
}


@pytest.mark.parametrize("case", list(BANDED_CASES))
def test_image_stats_banded_plain_matches_jax(case):
    shape, rows, fill = BANDED_CASES[case]
    rng = np.random.default_rng(sum(shape))
    imgs = (np.full(shape, fill, np.float32) if fill is not None
            else rng.integers(0, 256, shape).astype(np.float32))
    got = image_stats_banded_plain(torch.as_tensor(imgs), rows)
    want = jops.image_stats(jnp.asarray(imgs), interpret=True)
    np.testing.assert_array_equal(got["hist"].numpy(), _np(want["hist"]))
    for k in ("sobel_sum", "lap_sum", "lap_sq_sum"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=2e-5,
                                   atol=1e-3)
    want = jops.image_complexity(jnp.asarray(imgs), ComplexityConfig(),
                                 interpret=True)
    for k in SCORE_KEYS:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("rows", [None, 7, 16])
def test_image_stats_banded_epilogue_matches_jax(rows):
    """The kernel's f32 epilogue (fixed-tree entropy sum) on real-valued
    images, against the JAX package's scores."""
    from repro.data.synthetic import make_image

    rng = np.random.default_rng(5)
    imgs = np.stack([make_image(rng, u, 48, 64) for u in (0.1, 0.5, 0.9)])
    cc = ComplexityConfig(edge_p5=1.0, edge_p95=40.0, lap_p5=20.0,
                          lap_p95=1500.0)
    want = jops.image_complexity(jnp.asarray(imgs), cc, interpret=True)
    got = image_stats_banded_plain(torch.as_tensor(imgs), rows, cc)
    for k in SCORE_KEYS:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("shape,grid", [
    ((1, 64, 64), (64, 1)),        # the launcher's image: one block
    ((8, 1024, 1024), (32, 32)),   # 256 blocks: two an SM of 132
    ((1, 1024, 1024), (8, 128)),
    ((2, 33, 65), (33, 1)),
])
def test_image_stats_grid(shape, grid):
    assert image_stats_grid(*shape) == grid
    rows, bands = grid
    assert (bands - 1) * rows < shape[1] <= bands * rows


def test_image_stats_grid_multi_band_batches_fit_the_counters():
    """A launch takes tickets only with more than one band; the grid gives
    that only to batches of at most TARGET_BLOCKS images, the length of a
    stream's counter row."""
    from repro_torch.kernels.image_complexity import TARGET_BLOCKS

    for b in (1, 2, 8, 100, TARGET_BLOCKS, TARGET_BLOCKS + 1, 4096):
        for h, w in ((1024, 1024), (4096, 64), (33, 65), (10_000, 1)):
            rows, bands = image_stats_grid(b, h, w)
            assert bands == 1 or b <= TARGET_BLOCKS, (b, h, w)
            assert (bands - 1) * rows < h <= bands * rows


def test_image_complexity_on_cpu_makes_no_launch():
    imgs = torch.as_tensor(np.random.default_rng(6).uniform(
        0, 255, (2, 24, 40)).astype(np.float32))
    before = tops.image_stats.launches
    got = tops.image_complexity(imgs)  # CPU tensor -> plain, no launch
    assert tops.image_stats.launches == before
    stats = image_stats_plain(imgs)
    want = tops.image_complexity_from_stats(stats, 24, 40, ComplexityConfig())
    for k in SCORE_KEYS:
        assert torch.equal(got[k], want[k])
    assert torch.equal(got["hist"], stats["hist"])


def test_calibrate_percentiles_and_audio_scores_match_jax():
    from repro.core import complexity as jcx
    from repro.data.synthetic import make_image
    from repro_torch.core import complexity as tcx

    rng = np.random.default_rng(4)
    imgs = np.stack([make_image(rng, u, 32, 32)
                     for u in np.linspace(0.05, 0.95, 12)])
    want = jcx.calibrate_percentiles(jnp.asarray(imgs))
    got = tcx.calibrate_percentiles(torch.as_tensor(imgs))  # CPU: plain
    for f in ("edge_p5", "edge_p95", "lap_p5", "lap_p95"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5)
    frames = rng.standard_normal((2, 40, 16)).astype(np.float32)
    want = jcx.audio_complexity(jnp.asarray(frames))
    got = tcx.audio_complexity(frames)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# decode attention (dense cache)
# ---------------------------------------------------------------------------


def _dense_inputs(rng, b, t, h, kh, hd, fill):
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kc = rng.standard_normal((b, t, kh, hd)).astype(np.float32)
    vc = rng.standard_normal((b, t, kh, hd)).astype(np.float32)
    pos = np.full((b, t), -1, np.int32)
    pos[:, :fill] = np.arange(fill)
    pq = np.full((b,), fill - 1, np.int32)
    return q, kc, vc, pq, pos


def _check_dense(q, kc, vc, pq, pos, window=None):
    want = jattn.decode_attention_xla(jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(pq),
                                      jnp.asarray(pos), window=window)
    got = tref.decode_attention_ref(*map(torch.as_tensor,
                                         (q, kc, vc, pq, pos)), window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    return got.numpy()


@pytest.mark.parametrize("t,h,kh,hd,fill", [
    (256, 4, 4, 32, 256),
    (512, 8, 2, 64, 300),
    (512, 4, 1, 128, 100),
])
def test_decode_plain_matches_xla(t, h, kh, hd, fill):
    rng = np.random.default_rng(t + fill)
    _check_dense(*_dense_inputs(rng, 2, t, h, kh, hd, fill))


def test_decode_plain_ring_buffer_semantics():
    """Slot order must not matter, only absolute positions."""
    rng = np.random.default_rng(5)
    q, kc, vc, pq, pos = _dense_inputs(rng, 1, 128, 4, 2, 32, 128)
    base = _check_dense(q, kc, vc, pq, pos)
    roll = lambda x: np.roll(x, 37, axis=1)
    got = _check_dense(q, roll(kc), roll(vc), pq, roll(pos))
    np.testing.assert_allclose(got, base, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", [80, 97, 640])
def test_decode_plain_ragged_length(t):
    rng = np.random.default_rng(t)
    _check_dense(*_dense_inputs(rng, 2, t, 4, 2, 32, t))


def test_decode_plain_window():
    rng = np.random.default_rng(6)
    _check_dense(*_dense_inputs(rng, 1, 256, 4, 2, 64, 256), window=64)


def test_decode_plain_all_masked_slot_returns_mean_v():
    """A slot whose entries are all masked (empty or dead) returns the mean
    of the value rows it read, as the XLA path does (finite -1e30 fill)."""
    rng = np.random.default_rng(7)
    q, kc, vc, pq, pos = _dense_inputs(rng, 2, 96, 4, 2, 32, 50)
    pos[1] = -1
    got = _check_dense(q, kc, vc, pq, pos)
    mean_v = vc[1].mean(axis=0)  # (K, hd)
    np.testing.assert_allclose(got[1, 0].reshape(2, 2, 32),
                               np.repeat(mean_v[:, None], 2, axis=1),
                               rtol=1e-5, atol=1e-6)


def _live_only(pos, pq, lo, hi):
    """Only rows lo..hi-1 hold positions (0..); every other entry empty."""
    pos[:] = -1
    pos[:, lo:hi] = np.arange(hi - lo)
    pq[:] = hi - lo - 1


# scenario: (fill, window, all-masked last slot, live rows); T = 100 is no
# multiple of 16 or 32, so the last split is ragged
SPLIT_SCENARIOS = {
    "filled": (90, None, False, None),
    "all-masked slot": (90, None, True, None),
    "window": (90, 16, False, None),
    # rows 40-47 live: every split that misses them is wholly masked
    "masked splits": (None, None, True, (40, 48)),
}


@pytest.mark.parametrize("scenario", list(SPLIT_SCENARIOS))
@pytest.mark.parametrize("split_rows", [1, 16, 32, 200])
def test_decode_split_plain_matches_plain_and_xla(scenario, split_rows):
    """The kernel's split-and-merge arithmetic (partial m, l, acc per split
    with the -1e30 fill, merged by the max) against the unsplit plain
    version and JAX's XLA path."""
    fill, window, dead, live = SPLIT_SCENARIOS[scenario]
    rng = np.random.default_rng(split_rows + len(scenario))
    q, kc, vc, pq, pos = _dense_inputs(rng, 3, 100, 8, 2, 32, fill or 100)
    if live is not None:
        _live_only(pos, pq, *live)
    if dead:
        pos[2] = -1
    want = _check_dense(q, kc, vc, pq, pos, window=window)  # plain vs XLA
    got = decode_attention_split_plain(
        *map(torch.as_tensor, (q, kc, vc, pq, pos)), window=window,
        split_rows=split_rows).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    xla = jattn.decode_attention_xla(*map(jnp.asarray, (q, kc, vc, pq, pos)),
                                     window=window)
    np.testing.assert_allclose(got, _np(xla), rtol=RTOL, atol=ATOL)
    if dead:
        mean_v = vc[2].mean(axis=0)  # (K, hd)
        np.testing.assert_allclose(got[2, 0].reshape(2, 4, 32),
                                   np.repeat(mean_v[:, None], 4, axis=1),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,kh,t,sms,page", [
    (4, 4, 384, 132, None), (4, 2, 384, 132, 64), (4, 4, 4096, 132, 64),
    (4, 2, 4096, 132, 16), (1, 1, 1, 132, None), (1, 1, 10 ** 6, 132, 8),
])
def test_split_rows_for_fills_the_grid(b, kh, t, sms, page):
    rows = split_rows_for(b, kh, t, sms, page)
    assert rows >= MIN_SPLIT_ROWS and rows & (rows - 1) == 0
    splits = -(-t // rows)
    # as many splits as ~2 blocks an SM want, unless a split is already
    # the least (32 rows) or the largest it may be
    assert splits <= -(-2 * sms // (b * kh)) or rows == 1024
    assert rows == MIN_SPLIT_ROWS or (rows // 2) * -(-2 * sms // (b * kh)) < t
    if page is not None:
        assert rows % page == 0 or page % rows == 0


def _lean_inputs(rng, h, kh, hd, t, ring_last):
    """Three slots over a T-row cache: slot 0 filled to T - 10, slot 1 a
    wrapped ring (position p at row p % T up to ``ring_last``, the query
    there), slot 2 all masked (every entry empty)."""
    q, kc, vc, pq, pos = _dense_inputs(rng, 3, t, h, kh, hd, t - 10)
    p = np.arange(ring_last - t + 1, ring_last + 1)
    pos[1, p % t] = p
    pq[1] = ring_last
    pos[2] = -1
    return q, kc, vc, pq, pos


def test_lean_instances_are_the_wide_ones():
    """The bf16 kernel's lean instances (PV on the tensor cores, P rounded
    to bf16): kMaxG * hd/32 > 32."""
    lean = {(hd, g) for hd in (32, 64, 96, 128, 192, 256)
            for g in (1, 8, 9, 16) if lean_instance(hd, g)}
    assert lean == {(96, 9), (96, 16), (128, 9), (128, 16), (192, 1),
                    (192, 8), (192, 9), (192, 16), (256, 1), (256, 8),
                    (256, 9), (256, 16)}


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [8, 16])
@pytest.mark.parametrize("hd", [128, 192, 256])
def test_decode_split_plain_p_dtype_matches_xla(hd, group, p_dtype):
    """The lean instances' arithmetic (``decode_attention_split_plain`` with
    the split's unnormalised P rounded to ``p_dtype``) against JAX's XLA
    path, over a filled slot, a wrapped ring and an all-masked slot under a
    window of 100, in splits of 32 rows. f32: inputs and P in f32, 2e-5
    (summation order and the split merge differ). bf16: inputs rounded to
    bf16 on both sides, 2e-2, the kernels' bf16 tolerance: both round P to
    bf16, at different scales (XLA the normalised weights), and both round
    the output to bf16 (one ulp of a value in [1, 2) is 2^-7)."""
    rng = np.random.default_rng(hd + group)
    q, kc, vc, pq, pos = _lean_inputs(rng, 2 * group, 2, hd, 160, 290)
    if p_dtype == "bfloat16":
        jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, kc, vc)]
        tx = [torch.as_tensor(x).to(torch.bfloat16) for x in (q, kc, vc)]
        tol = 2e-2
    else:
        jx, tx, tol = [jnp.asarray(x) for x in (q, kc, vc)], [
            torch.as_tensor(x) for x in (q, kc, vc)], 2e-5
    want = _np(jattn.decode_attention_xla(*jx, jnp.asarray(pq),
                                          jnp.asarray(pos), window=100))
    args = (*tx, torch.as_tensor(pq), torch.as_tensor(pos))
    got = decode_attention_split_plain(*args, window=100, split_rows=32,
                                       p_dtype=getattr(torch, p_dtype))
    assert got.dtype == tx[0].dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    if p_dtype == "float32":  # the default is f32 P, bit for bit
        assert torch.equal(got, decode_attention_split_plain(
            *args, window=100, split_rows=32))
        mean_v = vc[2].mean(axis=0)  # (K, hd): the all-masked slot
        np.testing.assert_allclose(got[2, 0].numpy().reshape(2, group, hd),
                                   np.repeat(mean_v[:, None], group, axis=1),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# decode attention (paged pool)
# ---------------------------------------------------------------------------


def _paged_inputs(rng, b, h, kh, hd, page, n_pt, t, fill):
    n_pages = b * n_pt + 1
    kp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    pages = (rng.permutation(n_pages - 1)[:b * n_pt] + 1).reshape(
        b, n_pt).astype(np.int32)
    used = -(-fill // page)
    pages[:, used:] = 0  # unreserved tail -> the null page
    pos = np.full((b, t), -1, np.int32)
    pos[:, :fill] = np.arange(fill)
    pq = np.full((b,), fill - 1, np.int32)
    npg = -(-t // page)
    return q, kp, vp, pages[:, :npg], pq, pos


@pytest.mark.parametrize("t,fill,window", [
    (64, 64, None),     # whole pages
    (56, 40, None),     # partial last page, null-page tail
    (64, 60, 16),       # window
])
def test_paged_plain_matches_xla(t, fill, window):
    rng = np.random.default_rng(t * 7 + fill)
    args = _paged_inputs(rng, 3, 4, 2, 32, 16, 4, t, fill)
    want = jattn.decode_attention_paged_xla(*map(jnp.asarray, args),
                                            window=window)
    got = tref.decode_attention_paged_ref(*map(torch.as_tensor, args),
                                          window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    # the dispatcher on CPU tensors takes the same plain version, no launch
    before = tops.decode_attention_paged.launches
    via_ops = tops.decode_attention_paged(*map(torch.as_tensor, args),
                                          window=window)
    assert tops.decode_attention_paged.launches == before
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


# extents (``lens``) over T = 100 rows in pages of 16: 0 (a dead slot), 1, a
# page - 1, a page, a split of 32 +- 1 and T; the last slot's entries all
# masked (its extent's mean of V)
EXTENTS = (0, 1, 15, 16, 31, 33, 100, 100)


def _extent_inputs(seed):
    rng = np.random.default_rng(seed)
    b, t, page = len(EXTENTS), 100, 16
    q, kp, vp, pages, pq, pos = (torch.as_tensor(x) for x in _paged_inputs(
        rng, b, 8, 2, 32, page, 7, t, 90))
    pos[b - 1] = -1
    idx = pages.long()
    kc = kp[idx].reshape(b, -1, 2, 32)[:, :t]
    vc = vp[idx].reshape(b, -1, 2, 32)[:, :t]
    lens = torch.tensor(EXTENTS, dtype=torch.int32)
    return q, kp, vp, pages, pq, pos, kc, vc, lens


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("split_rows", [None, 1, 16, 32, 200])
def test_decode_extents_equal_per_slot_slicing(split_rows, window):
    """With extents, the paged plain version (``split_rows`` None) and the
    split mirror give each slot the plain version over its context sliced
    to its extent (f32, 1e-6); an extent of 0 gives zeros. Without them
    (``lens=None``) the paged plain version is bitwise the plain version
    over the gathered context, as before extents, and full extents agree
    with it."""
    q, kp, vp, pages, pq, pos, kc, vc, lens = _extent_inputs(
        (split_rows or 0) + (window or 0))
    if split_rows is None:
        got = decode_attention_paged_plain(q, kp, vp, pages, pq, pos,
                                           window=window, lens=lens)
        full = decode_attention_paged_plain(q, kp, vp, pages, pq, pos,
                                            window=window)
        assert torch.equal(full, tref.decode_attention_ref(
            q, kc, vc, pq, pos, window=window))
    else:
        got = decode_attention_split_plain(q, kc, vc, pq, pos, window=window,
                                           split_rows=split_rows, lens=lens)
        full = decode_attention_split_plain(q, kc, vc, pq, pos, window=window,
                                            split_rows=split_rows)
    every = torch.full_like(lens, pos.shape[1])
    whole = (decode_attention_paged_plain(q, kp, vp, pages, pq, pos,
                                          window=window, lens=every)
             if split_rows is None else decode_attention_split_plain(
                 q, kc, vc, pq, pos, window=window, split_rows=split_rows,
                 lens=every))
    torch.testing.assert_close(whole, full, rtol=1e-6, atol=1e-6)
    for i, e in enumerate(EXTENTS):
        if e == 0:
            assert torch.equal(got[i], torch.zeros_like(got[i]))
            continue
        want = tref.decode_attention_ref(
            q[i:i + 1], kc[i:i + 1, :e], vc[i:i + 1, :e], pq[i:i + 1],
            pos[i:i + 1, :e], window=window)
        torch.testing.assert_close(got[i:i + 1], want, rtol=1e-6, atol=1e-6)


def test_decode_extents_through_the_dispatchers_on_cpu():
    """``ops.decode_attention_paged`` and the model's dispatcher pass the
    extents to the plain version on CPU tensors (no launch), and clamp
    nothing themselves: an extent past T attends T rows."""
    from repro_torch.models import attention as tattn

    q, kp, vp, pages, pq, pos, _, _, lens = _extent_inputs(5)
    want = decode_attention_paged_plain(q, kp, vp, pages, pq, pos, lens=lens)
    before = tops.decode_attention_paged.launches
    for impl in ("auto", "torch"):
        got = tattn.decode_attention_paged(q, kp, vp, pages, pq, pos,
                                           impl=impl, lens=lens)
        assert torch.equal(got, want)
    assert tops.decode_attention_paged.launches == before
    past = torch.full_like(lens, 10 ** 6)
    assert torch.equal(
        tops.decode_attention_paged(q, kp, vp, pages, pq, pos, lens=past),
        decode_attention_paged_plain(q, kp, vp, pages, pq, pos,
                                     lens=torch.full_like(lens, 100)))


@pytest.mark.parametrize("extents,blocks,rows", [
    # phi-3-vision's cell: 12 live slots of 2650-3960 rows, 32 KV heads, a
    # grid of 4096 blocks (B x K x 4096 / 1024): 10 splits of 352 a slot
    ([3300] * 12 + [0] * 20, 4096, 352),
    # every slot live at 1401 rows of a 1536-row bucket, 4 KV heads, 528
    # blocks the card holds: 4 splits of 352 a slot, 512 items
    ([1401] * 32, 528, 352),
    # three live slots: the least split
    ([1500, 900, 1900] + [0] * 29, 528, 64),
    ([0] * 32, 528, 64),  # nothing live
    ([4096] * 32, 1024, 1024),  # the cap
])
def test_plan_split_rows(extents, blocks, rows):
    """The extent plan's split length (the CUDA kernel's ``plan_rows``):
    the least multiple of 32 rows from the least split whose items fit the
    grid; the grid always holds the items of the largest split."""
    kh = 32 if blocks == 4096 else 4 if blocks == 528 else 8
    got = plan_split_rows(extents, kh, blocks, 64, 1024)
    assert got == rows

    def items(r):
        return kh * sum(-(-e // r) for e in extents)
    assert items(got) <= blocks
    assert got == 64 or items(got - 32) > blocks
    t = max(max(extents), 1)
    grid = plan_blocks(32, kh, t, blocks, 64, 1024)
    assert 32 * kh * -(-t // 1024) <= grid <= 32 * kh * -(-t // 64)
    assert items(plan_split_rows(extents, kh, grid, 64, 1024)) <= grid


def test_decode_dispatcher_cuda_impl_refuses_cpu_tensors():
    from repro_torch.models import attention as tattn

    rng = np.random.default_rng(8)
    args = tuple(map(torch.as_tensor,
                     _dense_inputs(rng, 1, 32, 4, 2, 32, 20)))
    with pytest.raises(ValueError, match="cuda"):
        tattn.decode_attention(*args, impl="cuda")
    with pytest.raises(ValueError):
        decode_attention_cuda(*args)  # the kernel wrapper itself


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------


def _flash_inputs(seed, b, s, h, kh, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))


def _check_flash(q, k, v, *, dtype="float32", causal=True, window=None,
                 pallas=True):
    """The plain version against the JAX oracle (dense XLA attention) and,
    where the Pallas kernel takes S, the Pallas kernel in interpret mode;
    bf16 inputs are rounded alike on both sides and compared in f32."""
    tol = 2e-5 if dtype == "float32" else 2e-2
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    tq, tk, tv = (torch.as_tensor(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    wants = [jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)]
    if pallas:
        wants.append(jops.flash_attention(jq, jk, jv, causal=causal,
                                          window=window, block_q=64,
                                          block_k=64, interpret=True))
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                                   atol=tol)
    own = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(own.float().numpy(), got.float().numpy(),
                               rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("s,h,kh,hd", [
    (128, 4, 4, 32),   # MHA
    (128, 8, 2, 64),   # GQA
    (256, 4, 1, 64),   # MQA
])
def test_flash_plain_matches_pallas(s, h, kh, hd):
    _check_flash(*_flash_inputs(s + h + hd, 2, s, h, kh, hd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_dtypes(dtype):
    _check_flash(*_flash_inputs(11, 1, 128, 4, 2, 64), dtype=dtype)


@pytest.mark.parametrize("causal,window", [(False, None), (True, 64),
                                           (False, 64)])
def test_flash_plain_bidirectional_and_window(causal, window):
    _check_flash(*_flash_inputs(12, 1, 256, 4, 2, 32), causal=causal,
                 window=window)


@pytest.mark.parametrize("s", [97, 272])
def test_flash_plain_ragged_length(s):
    """Any S: the Pallas kernel asserts S % 128 == 0 past 128, so the
    reference here is the JAX dense path and the XLA flash path."""
    q, k, v = _flash_inputs(s, 2, s, 4, 2, 32)
    got = _check_flash(q, k, v, pallas=False)
    pos = jnp.arange(s, dtype=jnp.int32)
    want = jattn.flash_attention_xla(*map(jnp.asarray, (q, k, v)), pos, pos,
                                     causal=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


# the bf16 kernel's own tile loop (flash_attention_tiled_plain), in f32
# against the Pallas kernel and the plain version (f32 tolerance 1e-5: the
# only differences are the f32 summation order and exp2 against exp)
TILED_F32_TOL = 1e-5


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 40)])
@pytest.mark.parametrize("s,h,kh,hd", [
    (128, 4, 4, 32),   # MHA
    (256, 8, 2, 64),   # GQA
    (128, 4, 1, 128),  # MQA, the serving head dim
])
def test_flash_tiled_plain_matches_pallas(s, h, kh, hd, causal, window):
    """At S a multiple of 128, where the Pallas kernel takes S."""
    q, k, v = _flash_inputs(s * 3 + hd, 2, s, h, kh, hd)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window, block_q=64, block_k=64,
                                interpret=True)
    got = flash_attention_tiled_plain(*map(torch.as_tensor, (q, k, v)),
                                      causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TILED_F32_TOL,
                               atol=TILED_F32_TOL)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40), (False, 40)])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 97, 272, 320, 512])
def test_flash_tiled_plain_matches_plain_any_length(s, causal, window, hd):
    """Ragged S (keys past S excluded, the last tile narrower) and a window
    of 40, under which the first key tile a query tile reads is wholly
    masked for its last rows once S passes 104."""
    q, k, v = map(torch.as_tensor, _flash_inputs(s + hd, 1, s, 4, 2, hd))
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    got = flash_attention_tiled_plain(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TILED_F32_TOL,
                               atol=TILED_F32_TOL)
    # P rounded to bf16 as the kernel feeds it: within the bf16 tolerance
    got16 = flash_attention_tiled_plain(q, k, v, causal=causal, window=window,
                                        p_dtype=torch.bfloat16)
    np.testing.assert_allclose(got16.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("s,causal,window", [
    (320, True, None), (97, False, None), (512, True, 40), (300, False, 64),
    (1, True, 1), (200, True, 130)])
def test_flash_tile_range_skips_only_wholly_masked_tiles(s, causal, window):
    """A query tile reads exactly the key tiles that hold an attended
    (row, col) for one of its rows below S."""
    rows = torch.arange(s)
    diff = rows[:, None] - rows[None, :]
    ok = torch.ones((s, s), dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    q0 = torch.arange(0, s, BLOCK_Q)
    lo, hi = _tile_range(q0, s, causal, window, BLOCK_Q, BLOCK_K)
    for i, start in enumerate(q0.tolist()):
        for kt in range(-(-s // BLOCK_K)):
            attended = bool(ok[start:start + BLOCK_Q,
                               kt * BLOCK_K:(kt + 1) * BLOCK_K].any())
            assert attended == (int(lo[i]) <= kt <= int(hi[i])), (start, kt)
    if window == 40 and s == 512:  # some rows read a wholly masked tile
        assert not bool(ok[511, int(lo[-1]) * BLOCK_K:
                           (int(lo[-1]) + 1) * BLOCK_K].any())


def test_flash_wrapper_on_cpu_takes_plain_version():
    from repro_torch.models import attention as tattn

    q, k, v = map(torch.as_tensor, _flash_inputs(13, 2, 40, 4, 2, 32))
    before = tops.flash_attention.launches
    via_ops = tops.flash_attention(q, k, v)
    via_torch = tattn.attention(q, k, v, None, None, impl="torch")
    assert tops.flash_attention.launches == before
    want = flash_attention_plain(q, k, v)
    assert torch.equal(via_ops, want) and torch.equal(via_torch, want)


def test_prefill_dispatcher_refusals():
    from repro_torch.models import attention as tattn

    q, k, v = map(torch.as_tensor, _flash_inputs(14, 1, 32, 4, 2, 32))
    pos = torch.arange(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        tattn.attention(q, k, v, pos, pos, impl="cuda")
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v)  # the kernel wrapper itself
    # a cached context (chunk mode: Skv != Sq) needs positions: refused
    kc, vc = torch.cat([k, k], dim=1), torch.cat([v, v], dim=1)
    with pytest.raises(ValueError, match="Sq"):
        tattn.attention(q, kc, vc, pos, torch.arange(64), impl="torch")
    with pytest.raises(ValueError):
        tattn.attention(q, kc, vc, pos, torch.arange(64), impl="cuda")
    with pytest.raises(ValueError, match="Sq"):
        flash_attention_plain(q, kc, vc)
    with pytest.raises(ValueError):
        tattn.attention(q, k, v, pos, pos, impl="pallas")  # JAX spelling


# ---------------------------------------------------------------------------
# the CUDA kernels (need a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image_batch(device, shape, fill=None, seed=0):
    if fill is not None:
        return torch.full(shape, fill, dtype=torch.float32, device=device)
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, 256, shape).astype(np.float32), device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,fill", [
    ((1, 64, 64), None), ((2, 33, 65), None), ((3, 128, 96), None),
    ((1, 256, 256), None), ((1, 1, 1), None), ((1, 1, 7), None),
    ((1, 7, 1), None), ((1, 1024, 1024), None), ((2, 1024, 1024), None),
    ((1, 1024, 1024), 255.0), ((1, 1024, 1024), 0.0), ((2, 33, 65), 255.0)])
def test_image_stats_kernel_matches_plain(cuda, shape, fill):
    imgs = _image_batch(cuda, shape, fill)
    got, want = image_stats_cuda(imgs), tref.image_stats_batch_ref(imgs)
    assert torch.equal(got["hist"], want["hist"])
    for k in ("sobel_sum", "lap_sum", "lap_sq_sum"):
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 48, 64), (1, 1024, 1024)])
def test_image_complexity_kernel_matches_plain_scores(cuda, shape):
    from repro_torch.data.synthetic import make_image

    rng = np.random.default_rng(7)
    imgs = torch.as_tensor(np.ascontiguousarray(np.stack([
        make_image(rng, u, *shape[1:]) for u in np.linspace(
            0.1, 0.9, shape[0])])), device=cuda)
    cc = ComplexityConfig()
    got = image_complexity_cuda(imgs, cc)
    want = tops.image_complexity_from_stats(image_stats_plain(imgs),
                                            *shape[1:], cc)
    banded = image_stats_banded_plain(imgs, cc=cc)
    for k in SCORE_KEYS:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)
        torch.testing.assert_close(got[k], banded[k], rtol=0, atol=1e-6)
    before = tops.image_stats.launches
    out = tops.image_complexity(imgs, cc)  # the fused launch, counted
    assert tops.image_stats.launches == before + 1
    assert torch.equal(out["c_img"], got["c_img"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 33, 65), (8, 1024, 1024)])
def test_image_stats_kernel_is_bitwise_repeatable(cuda, shape):
    imgs = _image_batch(cuda, shape, seed=8)
    a, b = image_complexity_cuda(imgs), image_complexity_cuda(imgs)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
def test_image_stats_kernel_captures_in_cuda_graph(cuda):
    """No memset and no allocation in the C code, counters left at zero:
    the launch records into a CUDA graph, and replays equal eager calls."""
    imgs = _image_batch(cuda, (2, 1024, 1024), seed=9)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        image_complexity_cuda(imgs)  # warm: build, load, counters
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = image_complexity_cuda(imgs)
    for _ in range(2):
        imgs.copy_(255.0 - imgs)  # new pixels, same buffer
        graph.replay()
        torch.cuda.synchronize()
        want = image_complexity_cuda(imgs)
        for k in want:
            assert torch.equal(out[k], want[k]), k


@pytest.mark.gpu
def test_image_stats_kernel_on_two_streams(cuda):
    """Calls on two streams in turn (each stream its own counters) give
    the eager result on the default stream."""
    imgs = [_image_batch(cuda, (1, 1024, 1024), seed=s) for s in (10, 11)]
    want = [image_complexity_cuda(x) for x in imgs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(3):
        for s, x in zip(streams, imgs):
            with torch.cuda.stream(s):
                outs.append(image_complexity_cuda(x))
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        for k in out:
            assert torch.equal(out[k], want[i % 2][k]), (i, k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,hd", [(12, 2, 128), (28, 4, 128), (4, 2, 32)])
def test_decode_kernels_match_plain(cuda, dtype, h, kh, hd):
    dt = getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(h + hd)
    q, kc, vc, pq, pos = _dense_inputs(rng, 4, 256, h, kh, hd, 150)
    pos[3] = -1  # an all-masked slot
    t = lambda x: torch.as_tensor(x, device=cuda)
    q, kc, vc = t(q).to(dt), t(kc).to(dt), t(vc).to(dt)
    pq, pos = t(pq), t(pos)
    view = (q, kc[:, :192], vc[:, :192], pq, pos[:, :192])  # bucket view
    torch.testing.assert_close(decode_attention_cuda(*view).float(),
                               tref.decode_attention_ref(*view).float(),
                               rtol=tol, atol=tol)
    args = _paged_inputs(rng, 4, h, kh, hd, 64, 4, 200, 190)
    pt = [t(a) for a in args]
    pt[0], pt[1], pt[2] = pt[0].to(dt), pt[1].to(dt), pt[2].to(dt)
    torch.testing.assert_close(decode_attention_paged_cuda(*pt).float(),
                               tref.decode_attention_paged_ref(*pt).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,hd,causal,window,layout", [
    (4, 320, 12, 2, 128, True, None, "contiguous"),   # edge serving shape
    (4, 320, 28, 4, 128, True, None, "contiguous"),   # cloud serving shape
    (2, 97, 4, 1, 128, True, None, "contiguous"),     # ragged S
    (1, 272, 12, 2, 128, True, None, "bhsd"),         # 256 + 16, q view
    (2, 128, 4, 2, 32, True, 64, "contiguous"),       # hd 32, window
    (2, 200, 8, 2, 64, False, None, "unaligned"),     # hd 64, non-causal
])
def test_flash_kernel_matches_plain(cuda, dtype, b, s, h, kh, hd, causal,
                                    window, layout):
    dt = getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    q, k, v = (torch.as_tensor(x, device=cuda).to(dt)
               for x in _flash_inputs(s + hd, b, s, h, kh, hd))
    if layout == "bhsd":  # q a transposed view of a (B, H, S, hd) tensor
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "unaligned":  # odd offset, row stride hd + 1
        wide = torch.zeros((b, s, h, hd + 1), dtype=dt, device=cuda)
        wide[..., 1:] = q
        q = wide[..., 1:]
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    assert tops.flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# the bf16 kernel against its own tile loop with P rounded to bf16: the two
# differ only in the f32 summation order and the exp2 rounding, so the error
# is one bf16 ulp of the output (at most 2^-7 of it) where the two f32 results
# round apart, plus rare one-ulp flips of a bf16 P (each moves the output by
# at most 2^-8 of that key's weight times |v - o|): 8e-3, against 2e-2 for
# the plain version with f32 P
TILED_BF16_TOL = 8e-3

FLASH_TILED_CASES = {
    "edge R=4 S=320": (4, 320, 12, 2, 128, True, None, "contiguous"),
    "cloud R=4 S=320": (4, 320, 28, 4, 128, True, None, "contiguous"),
    "S=1": (2, 1, 12, 2, 128, True, None, "contiguous"),
    "S=64": (2, 64, 12, 2, 128, True, None, "contiguous"),
    "S=65": (2, 65, 12, 2, 128, True, None, "contiguous"),
    "cloud R=1 S=4096": (1, 4096, 28, 4, 128, True, None, "contiguous"),
    "window 40, leading tiles masked": (2, 320, 12, 2, 128, True, 40,
                                        "contiguous"),
    "non-causal window hd 32": (1, 160, 4, 2, 32, False, 64, "contiguous"),
    "non-causal hd 64 unaligned q": (2, 200, 8, 2, 64, False, None,
                                     "unaligned"),
    "q (B,H,S,hd) view S=272": (1, 272, 12, 2, 128, True, None, "bhsd"),
    # hd 64 (one 128-byte atom a tile) and hd 96 (the hd-128 tile, columns
    # 96-127 zero) on the wgmma kernel
    "hd 64 causal R=4 S=320": (4, 320, 12, 12, 64, True, None, "contiguous"),
    "hd 64 non-causal S=1500": (1, 1500, 12, 12, 64, False, None,
                                "contiguous"),
    "hd 64 window 40 ragged S=300": (2, 300, 8, 2, 64, True, 40,
                                     "contiguous"),
    "hd 64 unaligned q S=97": (2, 97, 4, 2, 64, True, None, "unaligned"),
    "hd 96 causal R=2 S=640": (2, 640, 32, 32, 96, True, None, "contiguous"),
    "hd 96 non-causal S=200": (2, 200, 8, 8, 96, False, None, "contiguous"),
    "hd 96 window 64 ragged S=97": (2, 97, 4, 4, 96, True, 64, "contiguous"),
    "hd 96 unaligned q": (2, 100, 4, 2, 96, True, None, "unaligned"),
    "hd 96 q (B,H,S,hd) view S=160": (2, 160, 8, 2, 96, True, None, "bhsd"),
}


def _flash_cuda_inputs(cuda, dt, b, s, h, kh, hd, layout, seed):
    q, k, v = (torch.as_tensor(x, device=cuda).to(dt)
               for x in _flash_inputs(seed, b, s, h, kh, hd))
    if layout == "bhsd":  # q a transposed view of a (B, H, S, hd) tensor
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "unaligned":  # odd offset, row stride hd + 1
        wide = torch.zeros((b, s, h, hd + 1), dtype=dt, device=cuda)
        wide[..., 1:] = q
        q = wide[..., 1:]
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLASH_TILED_CASES))
def test_flash_kernel_matches_tiled_plain(cuda, case):
    b, s, h, kh, hd, causal, window, layout = FLASH_TILED_CASES[case]
    q, k, v = _flash_cuda_inputs(cuda, torch.bfloat16, b, s, h, kh, hd,
                                 layout, s + h)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window).float()
    tiled = flash_attention_tiled_plain(q, k, v, causal=causal, window=window,
                                        p_dtype=torch.bfloat16).float()
    torch.testing.assert_close(got, tiled, rtol=TILED_BF16_TOL,
                               atol=TILED_BF16_TOL)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [128, 64, 96])
def test_flash_kernel_captures_in_cuda_graph(cuda, hd):
    """The launch records into a CUDA graph (the shared-memory opt-in is
    made once, outside any stream work); a replay equals an eager call."""
    q, k, v = _flash_cuda_inputs(cuda, torch.bfloat16, 4, 320, 28, 4, hd,
                                 "contiguous", 15)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_cuda(q, k, v)  # warm: build, load, opt-in
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention_cuda(q, k, v)
    q.copy_(q * -1)  # new queries, same buffers
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, flash_attention_cuda(q, k, v))


# the blocks an SM that flash_bf16_wgmma_kernel's launch bounds ask for
# (WgmmaOccupancy in the source): at hd 96 and 128 a 64-register output
# accumulator (168 registers a thread) and 66,560 bytes of shared memory;
# at hd 64 a 32-register accumulator and 33,792 bytes
WGMMA_BLOCKS_AN_SM = {64: 4, 96: 3, 128: 3}


@pytest.mark.gpu
@pytest.mark.parametrize("hd", sorted(WGMMA_BLOCKS_AN_SM))
def test_flash_bf16_kernel_holds_three_blocks_an_sm(cuda, hd):
    """bf16 hd 64, 96 and 128 run the wgmma kernel, with at least the
    blocks an SM its launch bounds ask for; hd 192 and 256 run the
    warp-specialised kernel and hd 32 the mma.sync one."""
    assert kernel_of(torch.bfloat16, hd) == "flash_bf16_wgmma_kernel"
    assert blocks_per_sm(torch.bfloat16, hd) >= WGMMA_BLOCKS_AN_SM[hd]
    assert kernel_of(torch.bfloat16, 32) == "flash_bf16_kernel"
    for other in (192, 256):
        assert kernel_of(torch.bfloat16, other) == "flash_bf16_ws_kernel"


# (b, h, kh, hd, t, fill, window, all-masked last slot, live rows, page,
#  forced split rows): the places where splitting the context can go wrong
DECODE_SPLIT_CASES = {
    "T=1": (2, 8, 2, 128, 1, 1, None, False, None, 16, None),
    "T=33": (2, 12, 2, 128, 33, 33, None, False, None, 16, None),
    "T=97": (2, 4, 1, 128, 97, 94, None, False, None, 16, None),
    "T=300 not a multiple of the split": (4, 28, 4, 128, 300, 295, None,
                                          False, None, 64, None),
    "T=4096": (4, 28, 4, 128, 4096, 4000, None, False, None, 64, None),
    "T=4096 all-masked slot": (4, 28, 4, 128, 4096, 4000, None, True, None,
                               64, None),
    "window 64 edge inside a split": (2, 8, 2, 64, 256, 200, 64, False, None,
                                      64, None),
    "one live split": (4, 28, 4, 128, 512, 224, None, False, (208, 224), 64,
                       None),
    "page 16 ends mid-page": (4, 28, 4, 128, 390, 385, None, False, None, 16,
                              None),
    "page 64 ends mid-page": (4, 12, 2, 128, 390, 385, None, True, None, 64,
                              None),
    "forced single split": (4, 28, 4, 128, 384, 380, None, False, None, 64,
                            512),
}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DECODE_SPLIT_CASES))
def test_decode_kernel_split_cases(cuda, case, dtype, layout):
    b, h, kh, hd, t, fill, window, dead, live, page, rows = (
        DECODE_SPLIT_CASES[case])
    dt = getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(t + h)
    dev = lambda x: torch.as_tensor(x, device=cuda)
    if layout == "dense":
        q, kc, vc, pq, pos = _dense_inputs(rng, b, t + 8, h, kh, hd, fill)
        pos = pos[:, :t]
        args = (q, kc[:, :t], vc[:, :t])  # a bucket view of a longer cache
    else:
        q, kp, vp, pages, pq, pos = _paged_inputs(
            rng, b, h, kh, hd, page, -(-t // page) + 1, t, fill)
        if dead:
            pages[b - 1] = 0  # a dead slot's table is all null page
        args = (q, kp, vp, pages)
    if live is not None:
        _live_only(pos, pq, *live)
    if dead:
        pos[b - 1] = -1
    args = [dev(x) for x in (*args, pq, pos)]
    for i in range(3):
        args[i] = args[i].to(dt)
    if layout == "dense":
        got = decode_attention_cuda(*args, window=window, split_rows=rows)
        want = tref.decode_attention_ref(*args, window=window)
        v_rows = args[2][b - 1]
    else:
        got = decode_attention_paged_cuda(*args, window=window,
                                          split_rows=rows)
        want = tref.decode_attention_paged_ref(*args, window=window)
        v_rows = args[2][0].repeat(-(-t // page), 1, 1)[:t]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dead:  # the all-masked slot returns the mean of its T value rows
        row = got[b - 1, 0].float().reshape(kh, h // kh, hd)
        mean_v = v_rows.float().mean(dim=0)[:, None].expand_as(row)
        torch.testing.assert_close(row, mean_v, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_kernels_capture_in_cuda_graph(cuda, layout):
    """Split and combine launches record into a CUDA graph (no host sync,
    no allocation in the C code); a replay equals an eager call."""
    rng = np.random.default_rng(9)
    dt = torch.bfloat16
    if layout == "dense":
        q, kc, vc, pq, pos = _dense_inputs(rng, 4, 512, 28, 4, 128, 380)
        args = [torch.as_tensor(x, device=cuda)
                for x in (q, kc[:, :384], vc[:, :384], pq, pos[:, :384])]
        fn = decode_attention_cuda
    else:
        args = [torch.as_tensor(x, device=cuda) for x in _paged_inputs(
            rng, 4, 28, 4, 128, 64, 8, 384, 380)]
        fn = decode_attention_paged_cuda
    for i in range(3):
        args[i] = args[i].to(dt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)  # warm: build, load, first allocations
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    args[0].copy_(args[0] * -1)  # new query, same buffers
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn(*args))


# the lean bf16 decode instances (PV on the tensor cores) at the zoo's wide
# shapes: (hd, query heads, KV heads, window)
LEAN_DECODE_CASES = {
    "hd128 group 16 (qwen3-moe)": (128, 64, 4, None),
    "hd192 group 12 (nemotron-4)": (192, 96, 8, None),
    "hd256 group 16, window (recurrentgemma)": (256, 16, 1, 100),
}

# a lean instance against its split mirror with P rounded to bf16: the
# kernel rounds P at its warp's running max, the mirror at the split's, so
# they differ by one bf16 ulp of the output where the f32 results round
# apart plus P's two roundings: 8e-3, as for flash's tile loop
LEAN_TOL = 8e-3


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "paged", "unaligned"])
@pytest.mark.parametrize("case", list(LEAN_DECODE_CASES))
def test_decode_lean_kernel_matches_plain_and_mirror(cuda, case, layout):
    """A filled slot, a wrapped ring and an all-masked slot (mean(V)) in
    bf16, against the plain version (2e-2) and the bf16-P split mirror
    (LEAN_TOL), over the rows a split the wrapper chooses; "unaligned":
    a dense cache whose rows start off 16 bytes (element copies)."""
    hd, h, kh, window = LEAN_DECODE_CASES[case]
    assert lean_instance(hd, h // kh)
    rng = np.random.default_rng(hd + h)
    t, page = 160, 16
    q, kc, vc, pq, pos = _lean_inputs(rng, h, kh, hd, t, 290)
    dev = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    q, kc, vc = (dev(x).to(torch.bfloat16) for x in (q, kc, vc))
    pq, pos = dev(pq), dev(pos)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if layout != "paged":
        if layout == "unaligned":  # odd offset, row stride hd + 1
            kc, vc = (torch.cat([x[..., :1], x], dim=-1)[..., 1:]
                      for x in (kc, vc))
        got = decode_attention_cuda(q, kc, vc, pq, pos, window=window)
        rows = split_rows_for(3, kh, t, sms)
    else:  # the same rows behind a shuffled page table over a pool
        n_pg = t // page
        perm = torch.as_tensor(rng.permutation(3 * n_pg) + 1, device=cuda)
        pages = perm.reshape(3, n_pg).to(torch.int32)
        pool = [torch.zeros((3 * n_pg + 1, page, kh, hd), dtype=torch.bfloat16,
                            device=cuda) for _ in range(2)]
        for x, pl in zip((kc, vc), pool):
            pl[pages.long()] = x.reshape(3, n_pg, page, kh, hd)
        got = decode_attention_paged_cuda(q, *pool, pages, pq, pos,
                                          window=window)
        rows = split_rows_for(3, kh, t, sms, page)
    want = tref.decode_attention_ref(q, kc, vc, pq, pos, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    mirror = decode_attention_split_plain(q, kc, vc, pq, pos, window=window,
                                          split_rows=rows,
                                          p_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), mirror.float(), rtol=LEAN_TOL,
                               atol=LEAN_TOL)
    row = got[2, 0].float().reshape(kh, h // kh, hd)
    mean_v = vc[2].float().mean(dim=0)[:, None].expand_as(row)
    torch.testing.assert_close(row, mean_v, rtol=2e-2, atol=2e-2)

