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
    decode_attention_cuda, decode_attention_paged_cuda)
from repro_torch.kernels.image_complexity import image_stats_cuda  # noqa: E402

torch.set_float32_matmul_precision("highest")

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
# the CUDA kernels (need a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 64, 64), (2, 33, 65), (3, 128, 96)])
def test_image_stats_kernel_matches_plain(cuda, shape):
    imgs = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, shape).astype(np.float32), device=cuda)
    got, want = image_stats_cuda(imgs), tref.image_stats_batch_ref(imgs)
    assert torch.equal(got["hist"], want["hist"])
    for k in ("sobel_sum", "lap_sum", "lap_sq_sum"):
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=1e-3)


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
