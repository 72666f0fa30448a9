"""The float32-accurate tensor-core product of the port's CUDA kernels
(3xTF32, ``src/repro_torch/kernels/csrc/common.cuh``), emulated in numpy.

``flash_attn_kernel`` (``wgmma.m64nNk8``) and ``ssd_scan_kernel``
(``mma.sync.m16n8k8``) run every product with tf32 operands: each float32
operand x is split into hi = tf32(x) and lo = tf32(x - hi), rounded as
``cvt.rna.tf32.f32`` rounds, and a.b is taken as a_lo.b_hi + a_hi.b_lo +
a_hi.b_hi.  These tests pin why: three passes meet the kernels' float32
tolerance at every inner length they reduce over, and through
``rwkv6_scan_kernel``'s whole chunk algebra at the decay clamp; one pass
does not.
They also pin the fragment layouts the kernels rely on.  Only numpy: the kernels themselves
run on the card in ``chip_smoke.py``.
"""
import numpy as np
import pytest

TOL = 2e-5                       # float32 attention tolerance, tests/test_kernels.py
# inner lengths the kernels reduce over: head_dim 32/64/80/128 (Q K^T), the
# kv tile and the SSD chunk (P V, scores x, x^T B), the state size N
LENGTHS = {"hd32 / kv tile": 32, "hd64 / chunk / N64": 64, "hd80": 80, "hd128": 128,
           "N16": 16}


def tf32_rna(x):
    """cvt.rna.tf32.f32 on finite float32: keep 10 mantissa bits, round to
    nearest with ties away from zero (the carry of half a tf32 ulp into the
    kept bits, as the kernels compute it)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mma_product(a, b, passes, acc=None):
    """acc + a (M, K) @ b (K, N) in float32 as the kernels take it: k-steps
    of 8, each pass's tf32 products exact, added to one float32 accumulator
    (zeros when acc is None)."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if passes == 3 else [(a_hi, b_hi)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32) if acc is None else acc.astype(np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            step = x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def operands(kind, k, seed):
    """Seeded float32 operands: randn against randn, or softmax-like weights
    in [0, 1] (rows summing to 1) against randn values."""
    rng = np.random.default_rng([seed, k])
    b = rng.standard_normal((k, 64)).astype(np.float32)
    if kind == "randn":
        return rng.standard_normal((64, k)).astype(np.float32), b
    logits = 2.0 * rng.standard_normal((64, k))
    p = np.exp(logits - logits.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)).astype(np.float32), b


def excess(out, ref):
    """How far the worst element is past the kernels' tolerance test
    (|out - ref| <= TOL + TOL |ref|); <= 0 passes."""
    return float(np.max(np.abs(out - ref) - TOL - TOL * np.abs(ref)))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    tie, below, above = one + np.float32(2.0 ** -11), one + np.float32(2.0 ** -12), \
        one + np.float32(2.0 ** -11 + 2.0 ** -13)
    got = tf32_rna(np.array([tie, -tie, below, above], np.float32))
    step = np.float32(2.0 ** -10)
    np.testing.assert_array_equal(got, [one + step, -(one + step), one, one + step])
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    hi, lo = split(x)
    assert not np.any(hi.view(np.uint32) & 0x1FFF) and not np.any(lo.view(np.uint32) & 0x1FFF)
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0 ** -11)      # half a tf32 ulp
    assert np.all(np.abs(x.astype(np.float64) - hi - lo) <= np.abs(x) * 2.0 ** -21)


@pytest.mark.parametrize("kind", ["randn", "softmax"])
@pytest.mark.parametrize("k", LENGTHS.values(), ids=LENGTHS.keys())
def test_three_passes_meet_the_f32_tolerance(k, kind):
    a, b = operands(kind, k, 1)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert excess(mma_product(a, b, 3), ref) <= 0


@pytest.mark.parametrize("kind", ["randn", "softmax"])
@pytest.mark.parametrize("k", LENGTHS.values(), ids=LENGTHS.keys())
def test_one_pass_misses_the_f32_tolerance(k, kind):
    a, b = operands(kind, k, 2)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert excess(mma_product(a, b, 1), ref) > 0


def mma_fragments(a_frag, b_frag):
    """mma.sync.m16n8k8 from its per-lane fragments (lane = 4 g + t):
    A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; B[t][g], B[t+4][g].  (Each
    warp of a wgmma.m64nNk8 holds its 16 rows of A in the same layout.)"""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane, ((a0, a1, a2, a3), (b0, b1)) in enumerate(zip(a_frag, b_frag)):
        g, t = divmod(lane, 4)
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a0, a1, a2, a3
        b[t, g], b[t + 4, g] = b0, b1
    return a @ b


@pytest.mark.parametrize("product", ["q_kT", "p_v", "xT_b"])
def test_fragment_layouts_of_the_kernels(product):
    """Q K^T (and the SSD's C B^T) takes A and B in the natural order.  The
    products that follow a softmax or a decay sum a k-step's 8 terms in the
    order (2t, 2t + 1) for A columns (t, t + 4): P V (and the SSD's
    ((C B^T) o L) x) feeds the accumulator of the scores (c0 = S[g][2t], c1
    = S[g][2t+1], c2 = S[g+8][2t], c3 = S[g+8][2t+1]) back as A unchanged,
    and the SSD state update reads x^T from rows 2t, 2t + 1 of x."""
    rng = np.random.default_rng(3)
    lanes = [divmod(lane, 4) for lane in range(32)]
    if product == "q_kT":                     # Q (16, 8 dims), K (8 keys, 8 dims)
        q, k = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
        a = [(q[g, t], q[g + 8, t], q[g, t + 4], q[g + 8, t + 4]) for g, t in lanes]
        b = [(k[g, t], k[g, t + 4]) for g, t in lanes]
        want = q @ k.T
    elif product == "p_v":                    # P (16 rows, 8 keys), V (8 keys, 8 columns)
        p, v = rng.random((16, 8)), rng.standard_normal((8, 8))
        c = [(p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t], p[g + 8, 2 * t + 1]) for g, t in lanes]
        a = [(c0, c2, c1, c3) for c0, c1, c2, c3 in c]
        b = [(v[2 * t, g], v[2 * t + 1, g]) for g, t in lanes]
        want = p @ v
    else:                                     # x (8 steps, 16 state rows), B (8 steps, 8 columns)
        x, bm = rng.standard_normal((8, 16)), rng.standard_normal((8, 8))
        a = [(x[2 * t, g], x[2 * t, g + 8], x[2 * t + 1, g], x[2 * t + 1, g + 8]) for g, t in lanes]
        b = [(bm[2 * t, g], bm[2 * t + 1, g]) for g, t in lanes]
        want = x.T @ bm
    np.testing.assert_allclose(mma_fragments(a, b), want, rtol=1e-12, atol=1e-12)


SCAN_TOL = 5 * TOL               # the scans' float32 tolerance (chip_smoke.py)


def rwkv_inputs(hd, decay, n_steps, seed=4):
    """One block's inputs as chip_smoke.py draws them: r, k, v (16 value
    columns), logw (-2 everywhere, the clamp, or drawn and clamped), u and
    a nonzero initial state slice (hd, 16)."""
    rng = np.random.default_rng([seed, hd])
    r, k = (0.5 * rng.standard_normal((2, n_steps, hd))).astype(np.float32)
    v = rng.standard_normal((n_steps, 16)).astype(np.float32)
    if decay == "clamp":
        logw = np.full((n_steps, hd), -2.0, np.float32)
    else:
        logw = np.maximum(-np.exp(0.5 * rng.standard_normal((n_steps, hd)) - 1.5), -2.0)
    u = 0.3 * rng.standard_normal(hd)
    s0 = 0.1 * rng.standard_normal((hd, 16))
    return r, k, v, logw.astype(np.float32), u.astype(np.float32), s0.astype(np.float32)


def rwkv_sequential(r, k, v, logw, u, s0):
    """y_t = r_t (S + diag(u) k_t^T v_t), S <- diag(exp(logw_t)) S + k_t^T v_t,
    in float64, one step at a time."""
    state, ys = s0.astype(np.float64), []
    for t in range(r.shape[0]):
        kv = np.outer(k[t], v[t]).astype(np.float64)
        ys.append(r[t].astype(np.float64) @ (state + u[:, None] * kv))
        state = np.exp(logw[t].astype(np.float64))[:, None] * state + kv
    return np.stack(ys), state


def rwkv_kernel_chunks(r, k, v, logw, u, s0, passes, q=32):
    """rwkv6_scan_kernel's chunk algebra in float32, every product through
    mma_product: r_f = r exp(cum_prev - tot) (up to e^64 at the clamp), k_f
    = k exp(tot - cum); scores r_f k_f^T over each half of hd, masked below
    the diagonal, r_t . (u o k_t) on it; rows 16-31 add the halves, rows
    0-15 keep them apart as partial tiles of A V; y = r_f (exp(tot) S) + A V
    in one accumulator; S <- exp(tot) S + k_f^T V."""
    f32, hd = np.float32, r.shape[1]
    state, ys = s0.astype(f32), []
    below = np.tril(np.ones((q, q), bool), -1)
    for c0 in range(0, r.shape[0], q):
        rc, kc, vc, lw = (x[c0:c0 + q] for x in (r, k, v, logw))
        cum = np.cumsum(lw, axis=0, dtype=f32)
        tot = cum[-1]
        r_f = (rc * np.exp(cum - lw - tot)).astype(f32)
        k_f = (kc * np.exp(tot - cum)).astype(f32)
        diag = np.diag((rc * u * kc).sum(1, dtype=f32))
        halves = [np.where(below, mma_product(r_f[:, d], k_f[:, d].T, passes), 0)
                  for d in (slice(0, hd // 2), slice(hd // 2, hd))]
        top = [halves[0][:16] + diag[:16], halves[1][:16]]          # rows 0-15, keys 0-15
        low = (halves[0][16:] + halves[1][16:]).astype(f32) + diag[16:]
        sdec = (state * np.exp(tot)[:, None]).astype(f32)
        read = mma_product(r_f, sdec, passes)
        a_top = np.concatenate([top[h][:, 8 * j:8 * j + 8] for j in (0, 1) for h in (0, 1)], 1)
        v_top = np.concatenate([vc[8 * j:8 * j + 8] for j in (0, 1) for _ in (0, 1)])
        ys.append(np.concatenate([mma_product(a_top, v_top, passes, acc=read[:16]),
                                  mma_product(low, vc, passes, acc=read[16:])]))
        state = mma_product(k_f.T, vc, passes, acc=sdec)
    return np.concatenate(ys), state


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("decay", ["clamp", "drawn"])
@pytest.mark.parametrize("hd", [32, 64])
def test_rwkv_chunk_on_3xtf32_at_the_decay_clamp(hd, decay, passes):
    """Three chunks of 32 from a nonzero state against the float64
    recurrence: three passes meet the scans' tolerance, one pass misses."""
    inputs = rwkv_inputs(hd, decay, 3 * 32)
    y_ref, s_ref = rwkv_sequential(*inputs)
    y, s = rwkv_kernel_chunks(*inputs, passes)
    worst = max(float(np.max(np.abs(out - ref) - SCAN_TOL - SCAN_TOL * np.abs(ref)))
                for out, ref in ((y, y_ref), (s, s_ref)))
    assert (worst <= 0) == (passes == 3), worst
