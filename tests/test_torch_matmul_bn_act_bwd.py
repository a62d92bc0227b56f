"""The backward of the port's matmul_bn_act held to the JAX package.

``jax.vjp`` of the JAX function (its Pallas backward kernel in interpret
mode, block_m=64 at M=300, so the last block is padded) against
``matmul_bn_act_bwd_plain`` on the same numpy inputs, with non-zero
cotangents on y, s1 and s2.  Bands: f32 at 1e-4 (sum order only, both in
full f32); bf16 at the forward's bf16 band, 1e-2 (bf16 roundings of dyt,
xhat, dx and dW in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.pallas.conv_bn import matmul_bn_act as jax_matmul_bn_act

from deeplearning4j_tpu_torch.ops.kernels import conv_bn

M, K, N = 300, 32, 48
CASES = [(True, True), (True, False), (False, False)]


def _inputs(prologue, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    a = rng.uniform(0.5, 1.5, K).astype(np.float32) if prologue else None
    b = (rng.normal(size=K) * 0.2).astype(np.float32) if prologue else None
    dy = rng.normal(size=(M, N)).astype(np.float32)
    ds1 = (rng.normal(size=N) * 0.3).astype(np.float32)
    ds2 = (rng.normal(size=N) * 0.1).astype(np.float32)
    return x, w, a, b, dy, ds1, ds2


def _jax_vjp(x, w, a, b, dy, ds1, ds2, relu_in, dtype):
    prims = [jnp.asarray(x, dtype), jnp.asarray(w, dtype)]
    if a is not None:
        prims += [jnp.asarray(a), jnp.asarray(b)]
    (y, _, _), vjp = jax.vjp(
        lambda *p: jax_matmul_bn_act(*p, relu_in=relu_in, block_m=64), *prims)
    grads = vjp((jnp.asarray(dy, dtype), jnp.asarray(ds1), jnp.asarray(ds2)))
    return np.array(y.astype(jnp.float32)), [np.array(g.astype(jnp.float32)) for g in grads]


def _plain(x, w, a, b, y, dy, ds1, ds2, relu_in, dtype):
    t = lambda v, d=dtype: None if v is None else torch.from_numpy(v).to(d)  # noqa: E731
    out = conv_bn.matmul_bn_act_bwd_plain(
        t(x), t(w), t(a, torch.float32), t(b, torch.float32), t(y), t(dy),
        t(ds1, torch.float32), t(ds2, torch.float32), relu_in=relu_in)
    return [g.float().numpy() for g in out if g is not None]


@pytest.mark.parametrize("prologue,relu_in", CASES)
def test_plain_backward_matches_pallas_f32(prologue, relu_in):
    x, w, a, b, dy, ds1, ds2 = _inputs(prologue)
    y, want = _jax_vjp(x, w, a, b, dy, ds1, ds2, relu_in, jnp.float32)
    got = _plain(x, w, a, b, y, dy, ds1, ds2, relu_in, torch.float32)
    assert len(got) == len(want) == (4 if prologue else 2)
    for name, g, e in zip(("dx", "dw", "da", "db"), got, want):
        np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("prologue,relu_in", CASES)
def test_plain_backward_matches_pallas_bf16(prologue, relu_in):
    x, w, a, b, dy, ds1, ds2 = _inputs(prologue, seed=1)
    y, want = _jax_vjp(x, w, a, b, dy, ds1, ds2, relu_in, jnp.bfloat16)
    y = np.array(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))
    got = _plain(x, w, a, b, y, dy, ds1, ds2, relu_in, torch.bfloat16)
    for name, g, e in zip(("dx", "dw", "da", "db"), got, want):
        np.testing.assert_allclose(g, e, rtol=1e-2, atol=1e-2, err_msg=name)


@pytest.mark.parametrize("prologue,relu_in", CASES)
@pytest.mark.parametrize("stats_cotangents", [True, False])
def test_function_gradients_equal_plain_backward(prologue, relu_in, stats_cotangents):
    """On the CPU the autograd.Function runs the plain pair: its gradients
    are the plain backward's, bit for bit, with the s1/s2 cotangents given
    or left for autograd to materialize as zeros; no kernel launches."""
    x, w, a, b, dy, ds1, ds2 = (None if v is None else torch.from_numpy(v)
                                for v in _inputs(prologue, seed=2))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, a, b) if t is not None]
    before = (conv_bn.launches, conv_bn.bwd_launches)
    y, s1, s2 = conv_bn.matmul_bn_act(*leaves, relu_in=relu_in)
    if stats_cotangents:
        got = torch.autograd.grad((y, s1, s2), leaves, (dy, ds1, ds2))
    else:
        got = torch.autograd.grad(y, leaves, dy)
        ds1, ds2 = torch.zeros(N), torch.zeros(N)
    want = conv_bn.matmul_bn_act_bwd_plain(x, w, a, b, y.detach(), dy, ds1, ds2,
                                           relu_in=relu_in)
    assert len(got) == len([g for g in want if g is not None])
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    assert (conv_bn.launches, conv_bn.bwd_launches) == before


@pytest.mark.parametrize("sms", [132, 114])   # H100 SXM, H100 PCIe
def test_dw_splits_cover_m_and_fill_the_card(sms):
    """The backward's plan (``bwd_plan``): the dW kernel's M splits cover M
    in whole stages, in order, and with the (K, N) tiles fill one wave of
    the card's SMs where M allows, no more; the dx tiles, the da/db tables
    and the arrival counts fit the tiles."""
    for dtype in (torch.float32, torch.bfloat16):
        step = conv_bn.M_STEP[dtype]
        for m, k, n in [(100352, 64, 64), (1568, 2048, 512), (1568, 1024, 2048), (300, 32, 48),
                        (7, 64, 64), (802816, 64, 256), (100352, 1000, 200)]:
            p = conv_bn.bwd_plan(m, k, n, dtype, sms)
            assert p["steps"] == -(-m // step)
            ranges = p["step_ranges"]
            assert len(ranges) == p["splits"] and ranges[0][0] == 0 and ranges[-1][1] == p["steps"]
            assert all(r0 < r1 for r0, r1 in ranges)
            assert all(u[1] == v[0] for u, v in zip(ranges, ranges[1:]))
            assert (p["tiles_k"], p["tiles_n"]) == (-(-k // conv_bn.DW_TILE_K),
                                                    -(-n // conv_bn.DW_TILE_N))
            tiles = p["tiles_k"] * p["tiles_n"]
            # one wave: as many splits as the card holds, no more
            assert p["splits"] * tiles <= max(sms, tiles)
            assert p["splits"] == 1 or p["splits"] == p["steps"] or (p["splits"] + 1) * tiles > sms
            slices, per_tile = conv_bn.split_scratch(p["splits"])
            assert p["part"] == ((slices, k, n) if p["splits"] > 1 else (0,))
            tiles_m = -(-m // conv_bn.DX_TILE_M)
            groups = -(-tiles_m // conv_bn.GROUP)
            assert (p["tiles_m"], p["groups"], p["tiles_kx"]) == (tiles_m, groups,
                                                                  -(-k // conv_bn.DX_TILE_K))
            assert p["stats"] == (2, tiles_m + groups, k)
            sum_blocks = 2 * p["tiles_kx"]
            assert sum_blocks * conv_bn.SUM_COLS == p["tiles_kx"] * conv_bn.DX_TILE_K
            assert p["counts"] == sum_blocks * (groups + 1) + (tiles * per_tile
                                                                if p["splits"] > 1 else 0)


@pytest.mark.parametrize("splits,want", [(1, (1, 1)), (2, (2, 1)), (8, (8, 1)), (9, (11, 3)),
                                         (66, (75, 10)), (132, (149, 18))])
def test_split_scratch_adds_groups_past_one_group(splits, want):
    """A tile split past one group of ``SPLIT_GROUP`` gets a slice and an
    arrival count per group beside the splits' own, and one more count."""
    assert conv_bn.split_scratch(splits) == want


@pytest.mark.parametrize("k,n", [(4, 8), (100, 24), (1000, 200), (64, 256)])
def test_rows_are_padded_to_the_tma_pitch(k, n):
    """``row_aligned`` pads a row to a multiple of 16 bytes with zeros (the
    kernels' TMA maps need that row pitch), and leaves aligned rows alone."""
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.randn(5, k).to(dtype)
        got = conv_bn.row_aligned(t)
        per = 16 // t.element_size()
        assert got.shape[1] % per == 0 and got.shape[1] - k < per
        assert torch.equal(got[:, :k], t) and not got[:, k:].any()
        assert (got is t) == (k % per == 0)
