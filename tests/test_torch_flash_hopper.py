"""The warp-specialised bf16 flash kernel (``flash_bf16_ws_kernel``, bf16
hd 192 and 256) against the JAX package, through its tile-loop mirror.

On the CPU the kernel cannot run; ``flash_attention_tiled_plain`` at the
kernel's tile sizes (``tiles("flash_bf16_ws_kernel")``: 128-row query
tiles, 64-key tiles) is its loop in PyTorch, and these tests hold that
mirror to the Pallas kernel in interpret mode (``repro.kernels.ops``, which
pads hd 192 to 256) and to ``repro.kernels.ref.flash_attention_ref`` on the
same numpy inputs, at the zoo's shapes: nemotron-4's hd 192 with 12 query
heads a KV head, recurrentgemma's hd 256 with 16. The cases marked ``gpu``
hold the kernel itself to the mirror on the card and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _DTYPES, BLOCK_K, BLOCK_Q, WS_BLOCK_Q, _kernel_id, _launch, _lib,
    _tile_range, flash_attention_cuda, flash_attention_plain,
    flash_attention_tiled_plain, kernel_of, tiles)

#: tests/test_kernels.py's tolerances: f32 against the Pallas kernel and the
#: XLA reference; bf16 with P rounded to bf16 (as the kernel feeds it to the
#: tensor cores) against JAX's bf16 run
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the kernel against its mirror on the card (tests/test_torch_kernels.py)
TILED_BF16_TOL = 8e-3
WS = "flash_bf16_ws_kernel"


def _inputs(seed, b, s, h, kh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kh, hd)).astype(np.float32),
            rng.standard_normal((b, s, kh, hd)).astype(np.float32))


def _mirror(q, k, v, causal, window, p_dtype=torch.float32):
    block_q, block_k = tiles(WS)
    return flash_attention_tiled_plain(q, k, v, causal=causal, window=window,
                                       block_q=block_q, block_k=block_k,
                                       p_dtype=p_dtype)


def test_ws_tiles_are_128_query_rows_by_64_keys():
    assert tiles(WS) == (WS_BLOCK_Q, BLOCK_K) == (128, 64)
    for other in ("flash_f32_kernel", "flash_bf16_kernel",
                  "flash_bf16_wgmma_kernel"):
        assert tiles(other) == (BLOCK_Q, BLOCK_K) == (64, 64)
    with pytest.raises(ValueError):
        tiles("flash_bf16_kernel_v2")


# (s, h, kh, hd, causal, window): S a multiple of 128 or at most 128, as
# the Pallas kernel takes it; S=256 gives two 128-row query tiles
PALLAS_CASES = [
    (128, 12, 1, 192, True, None), (128, 12, 1, 192, False, None),
    (128, 12, 1, 192, True, 48), (256, 12, 1, 192, True, 100),
    (128, 16, 1, 256, True, None), (128, 16, 1, 256, False, None),
    (128, 16, 1, 256, True, 48), (256, 16, 1, 256, True, None),
]


@pytest.mark.parametrize("s,h,kh,hd,causal,window", PALLAS_CASES)
def test_ws_mirror_matches_pallas(s, h, kh, hd, causal, window):
    q, k, v = _inputs(s + h + hd, 1, s, h, kh, hd)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window, interpret=True)
    got = _mirror(*map(torch.as_tensor, (q, k, v)), causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("hd,h,window", [(192, 12, None), (256, 16, 48)])
def test_ws_mirror_bf16_matches_pallas_bf16(hd, h, window):
    """bf16 inputs in both packages (cast from the same f32 draws, round to
    nearest even in both), P rounded to bf16 in the mirror."""
    q, k, v = _inputs(hd + 7, 1, 128, h, 1, hd)
    want = jops.flash_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=True, window=window, interpret=True)
    got = _mirror(*(torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)),
                  True, window, p_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


# ragged S (the Pallas kernel asserts S % 128 == 0 past 128): against the
# XLA reference; a 128-row query tile whose second half lies past S, a
# window whose leading key tile is wholly masked for a tile's last rows
RAGGED_CASES = [
    (97, 12, 1, 192, True, None), (200, 12, 1, 192, False, None),
    (300, 16, 1, 256, True, 40), (65, 16, 1, 256, True, None),
    (1, 16, 1, 256, True, None), (130, 24, 2, 192, True, 64),
]


@pytest.mark.parametrize("s,h,kh,hd,causal,window", RAGGED_CASES)
def test_ws_mirror_matches_xla_reference_any_length(s, h, kh, hd, causal,
                                                    window):
    q, k, v = _inputs(s * 5 + hd, 2, s, h, kh, hd)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, window=window)
    got = _mirror(*map(torch.as_tensor, (q, k, v)), causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL["float32"], atol=TOL["float32"])
    # and the port's plain version, which defines the semantics
    plain = flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                  causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,causal,window", [
    (300, True, 40), (200, False, None), (97, True, None), (256, True, 100)])
def test_128_row_tiles_equal_64_row_tiles_bitwise(s, causal, window, p_dtype):
    """A 128-row query tile only adds key tiles that are wholly masked for
    some of its rows: after an attended tile such a tile multiplies by
    2^0 = 1 and adds 0, before one it is wiped by 2^(-1e30 log2 e - m) = 0;
    so the mirror gives the same bits at either height."""
    q, k, v = map(torch.as_tensor, _inputs(s + 3, 1, s, 12, 1, 192))
    wide = _mirror(q, k, v, causal, window, p_dtype)
    narrow = flash_attention_tiled_plain(q, k, v, causal=causal,
                                         window=window, p_dtype=p_dtype)
    assert torch.equal(wide, narrow)


@pytest.mark.parametrize("s,causal,window", [
    (320, True, None), (97, False, None), (512, True, 40), (300, False, 64),
    (1, True, 1), (4096, True, 2048)])
def test_ws_tile_range_skips_only_wholly_masked_tiles(s, causal, window):
    """A 128-row query tile reads exactly the key tiles that hold an
    attended (row, col) for one of its rows below S."""
    rows = torch.arange(s)
    diff = rows[:, None] - rows[None, :]
    ok = torch.ones((s, s), dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    q0 = torch.arange(0, s, WS_BLOCK_Q)
    lo, hi = _tile_range(q0, s, causal, window, WS_BLOCK_Q, BLOCK_K)
    for i, start in enumerate(q0.tolist()):
        attended = ok[start:start + WS_BLOCK_Q].reshape(-1, s).any(0)
        for kt in range(-(-s // BLOCK_K)):
            hit = bool(attended[kt * BLOCK_K:(kt + 1) * BLOCK_K].any())
            assert hit == (int(lo[i]) <= kt <= int(hi[i])), (start, kt)


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_inputs(cuda, b, s, h, kh, hd, layout, seed):
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16)
               for x in _inputs(seed, b, s, h, kh, hd))
    if layout == "bhsd":  # q a transposed view of a (B, H, S, hd) tensor
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "unaligned":  # odd offset, row stride hd + 1: no TMA
        wide = torch.zeros((b, s, h, hd + 1), dtype=torch.bfloat16,
                           device=cuda)
        wide[..., 1:] = q
        q = wide[..., 1:]
    return q, k, v


WS_CUDA_CASES = {
    "nemotron 96/8 S=256": (1, 256, 96, 8, 192, True, None, "contiguous"),
    "nemotron 96/8 R=4 S=512": (4, 512, 96, 8, 192, True, None,
                                "contiguous"),
    "hd 192 12/1 non-causal S=97": (2, 97, 12, 1, 192, False, None,
                                    "contiguous"),
    "hd 192 unaligned q window 40": (2, 200, 12, 1, 192, True, 40,
                                     "unaligned"),
    "recurrentgemma 16/1 S=2500 window 2048": (1, 2500, 16, 1, 256, True,
                                               2048, "contiguous"),
    "hd 256 q (B,H,S,hd) view S=130": (2, 130, 16, 1, 256, True, None,
                                       "bhsd"),
    "hd 256 unaligned q S=100": (2, 100, 4, 1, 256, True, None, "unaligned"),
    "hd 256 S=1": (2, 1, 16, 1, 256, True, None, "contiguous"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(WS_CUDA_CASES))
def test_ws_kernel_matches_mirror_and_repeats(cuda, case):
    b, s, h, kh, hd, causal, window, layout = WS_CUDA_CASES[case]
    q, k, v = _cuda_inputs(cuda, b, s, h, kh, hd, layout, s + h)
    assert kernel_of(torch.bfloat16, hd) == WS
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    mirror = _mirror(q, k, v, causal, window, p_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), mirror.float(),
                               rtol=TILED_BF16_TOL, atol=TILED_BF16_TOL)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(got, flash_attention_cuda(q, k, v, causal=causal,
                                                 window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [192, 256])
def test_ws_kernel_captures_in_cuda_graph(cuda, hd):
    q, k, v = _cuda_inputs(cuda, 1, 640, 16, 1, hd, "contiguous", 5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_cuda(q, k, v)  # warm: build, load, opt-in
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention_cuda(q, k, v)
    q.copy_(q * -1)  # new queries, same buffers: the tensor maps hold
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, flash_attention_cuda(q, k, v))


@pytest.mark.gpu
def test_ws_kernel_pinned_at_hd_128_matches_its_mirror(cuda):
    """The warp-specialised kernel at hd 128, off the route (a timing
    record), is held to its mirror as at 192 and 256."""
    q, k, v = _cuda_inputs(cuda, 4, 320, 28, 4, 128, "contiguous", 9)
    assert kernel_of(torch.bfloat16, 128) == "flash_bf16_wgmma_kernel"
    assert _lib().flash_attention_blocks_per_sm(
        _DTYPES[torch.bfloat16], 128, _kernel_id(WS)) >= 1
    got = _launch(q, k, v, True, None, WS)
    mirror = _mirror(q, k, v, True, None, p_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), mirror.float(),
                               rtol=TILED_BF16_TOL, atol=TILED_BF16_TOL)
