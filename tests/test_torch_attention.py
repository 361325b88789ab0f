"""The port's flash attention against the JAX package's Pallas kernel (run in
interpret mode, as tests/test_kernels.py runs it) and its oracle, on small
inputs.  On the CPU the wrapper runs its plain version; the CUDA kernel is
held against that plain version on a card by tests/test_torch_cuda.py and
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import flash_attention as tfa_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

# (sq, sk, D, causal, Hq, Hkv): JAX's own sweep, the two sq != sk causal
# cases where the kernel and its oracle part (R6), phi3-mini's head dim 96,
# qwen2.5-32b's SMOKE head geometry (64 / 4 heads, 2 kv heads) and a
# non-causal group of three
CASES = [(128, 128, 64, True, 4, 2), (128, 256, 64, False, 4, 2),
         (256, 256, 32, True, 4, 2),
         (64, 128, 32, True, 4, 2), (128, 64, 32, True, 4, 2),
         (128, 128, 96, True, 4, 4), (128, 128, 16, True, 4, 2),
         (128, 128, 64, False, 6, 2)]
R6_CASES = [c for c in CASES if c[3] and c[0] != c[1]]
BLOCK = 64
# fp32: the same sums in another order; bf16: one rounding of the output
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(sq, sk, d, hq, hkv, dtype, seed=0):
    """The same q, k, v on both sides: float32 numpy arrays, cast to
    ``dtype`` by each package (both round to nearest even)."""
    rng = np.random.default_rng(seed + sq + 3 * sk + 7 * d + hq)
    arrs = [rng.standard_normal((1, h, s, d)).astype(np.float32)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]
    jx = [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in arrs]
    tx = [convert.dense_from_numpy(x, getattr(torch, dtype), "cpu")
          for x in arrs]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,d,causal,hq,hkv", CASES)
def test_flash_attention_matches_the_pallas_kernel(sq, sk, d, causal, hq,
                                                   hkv, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq, sk, d, hq, hkv, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=BLOCK,
                                block_k=BLOCK)
    got = tops.flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK,
                               block_k=BLOCK)
    assert got.dtype == tq.dtype and got.shape == (1, hq, sq, d)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("sq,sk,d,causal,hq,hkv", CASES)
def test_attention_ref_matches_the_jax_oracle(sq, sk, d, causal, hq, hkv):
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq, sk, d, hq, hkv, "float32")
    np.testing.assert_allclose(
        _f32(tref.attention_ref(tq, tk, tv, causal=causal)),
        _f32(jref.attention_ref(jq, jk, jv, causal=causal)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,sk,d,causal,hq,hkv", R6_CASES)
def test_kernel_and_oracle_masks_part_where_sq_differs_from_sk(sq, sk, d,
                                                               causal, hq,
                                                               hkv):
    """R6: the kernel's causal mask is top-left, its oracle's bottom-right,
    in both packages alike."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq, sk, d, hq, hkv, "float32")
    kw = dict(causal=True, block_q=BLOCK, block_k=BLOCK)
    t_gap = np.abs(_f32(tops.flash_attention(tq, tk, tv, **kw))
                   - _f32(tref.attention_ref(tq, tk, tv))).max()
    j_gap = np.abs(_f32(jops.flash_attention(jq, jk, jv, **kw))
                   - _f32(jref.attention_ref(jq, jk, jv))).max()
    assert t_gap > 0.1 and j_gap > 0.1


def test_bf16_inputs_are_the_same_on_both_sides():
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    x[:4] = [1.00390625, 1.01171875, -3.0078125, 65504.5]   # ties and more
    got = convert.dense_from_numpy(x, torch.bfloat16, "cpu")
    want = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_plain_version_chunks_query_rows_without_changing_the_result(
        monkeypatch):
    """Query chunks that do not divide Sq, causal and not, with a group of
    two: the chunked mask rows and the head mapping stay aligned."""
    _, (q, k, v) = _inputs(192, 256, 32, 4, 2, "float32", seed=9)
    for causal in (True, False):
        whole = tfa_k.flash_attention_plain(q, k, v, causal=causal)
        monkeypatch.setattr(tfa_k, "PLAIN_CHUNK", 40)
        parts = tfa_k.flash_attention_plain(q, k, v, causal=causal)
        monkeypatch.undo()
        torch.testing.assert_close(parts, whole, rtol=1e-6, atol=1e-6)


def test_gqa_maps_each_kv_head_to_a_contiguous_group_of_q_heads():
    """q head h reads kv head h // group (JAX's reshape), not h % Hkv."""
    _, (q, k, v) = _inputs(64, 64, 16, 6, 2, "float32", seed=5)
    got = tops.flash_attention(q, k, v, causal=False, block_q=64,
                               block_k=64)
    for h in range(6):
        g = slice(h // 3, h // 3 + 1)
        one = tfa_k.flash_attention_plain(q[:, h:h + 1], k[:, g], v[:, g],
                                          causal=False)
        torch.testing.assert_close(got[:, h:h + 1], one, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("what", ["heads", "block_q", "block_k"])
def test_flash_attention_refuses_what_jax_asserts(what):
    hq, sq, sk = (3 if what == "heads" else 4,
                  96 if what == "block_q" else 128,
                  96 if what == "block_k" else 128)
    q = torch.zeros(1, hq, sq, 16)
    k = torch.zeros(1, 2, sk, 16)
    with pytest.raises(ValueError, match="flash_attention"):
        tops.flash_attention(q, k, k, block_q=64, block_k=64)


def test_flash_attention_refuses_other_dtypes_and_mixed_devices():
    q = torch.zeros(1, 4, 64, 16)
    k = torch.zeros(1, 2, 64, 16)
    kw = dict(block_q=64, block_k=64)
    with pytest.raises(TypeError):
        tops.flash_attention(q.int(), k.int(), k.int(), **kw)
    with pytest.raises(TypeError):
        tops.flash_attention(q, k.half(), k, **kw)
    with pytest.raises(RuntimeError, match="one CUDA device"):
        tops.flash_attention(q, k.to("meta"), k, **kw)


def test_plain_runs_on_the_cpu_without_counting_a_launch():
    before = tfa_k.flash_attention.launches
    _, (q, k, v) = _inputs(64, 64, 16, 4, 2, "bfloat16")
    out = tops.flash_attention(q, k, v, block_q=64, block_k=64)
    assert out.dtype == torch.bfloat16 and not out.requires_grad
    assert tfa_k.flash_attention.launches == before


# --------------------------------------------------------------------------- #
# Which kernel a CUDA call launches, and the sm90 kernel's key-tile schedule
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [16, 32, 48, 64, 96, 128, 160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_variant_follows_dtype_and_head_dim(dtype, d):
    """bf16 and f16 at D 64, 96 and 128 go to the wgmma kernel, every other
    (dtype, D) to the mma.sync (3xTF32) one."""
    want = ("sm90" if dtype != torch.float32 and d in (64, 96, 128)
            else "mma")
    assert tfa_k.variant(dtype, d) == want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float16, 96),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 128),
                                     (torch.float16, 256)])
def test_a_cuda_call_launches_its_variant_and_no_other(monkeypatch, dtype,
                                                       d):
    """The wrapper picks the kernel before the launch from dtype and D; the
    launches count under the variant and under ``flash_attention``."""
    picked = []
    for name in ("flash_attention_sm90", "flash_attention_mma"):
        fake = (lambda name: lambda q, k, v, *, causal: picked.append(name)
                or torch.zeros_like(q))(name)
        monkeypatch.setattr(tfa_k, name, fake)
    monkeypatch.setattr(tfa_k._build, "kernel_device",
                        lambda name, *ts: torch.device("cpu"))
    before = tfa_k.flash_attention.launches
    _, (q, k, v) = _inputs(64, 64, d, 4, 2, "float32")
    q, k, v = (x.to(dtype) for x in (q, k, v))
    tfa_k.flash_attention(q, k, v, block_q=64, block_k=64)
    assert picked == [f"flash_attention_{tfa_k.variant(dtype, d)}"]
    assert tfa_k.flash_attention.launches == before + 1


def test_a_failed_sm90_launch_raises_without_a_fallback(monkeypatch):
    def broken(q, k, v, *, causal):
        raise RuntimeError("flash_attention_sm90: CUDA error")

    def other(q, k, v, *, causal):
        raise AssertionError("fell back to the mma kernel")

    monkeypatch.setattr(tfa_k, "flash_attention_sm90", broken)
    monkeypatch.setattr(tfa_k, "flash_attention_mma", other)
    monkeypatch.setattr(tfa_k, "flash_attention_plain", other)
    monkeypatch.setattr(tfa_k._build, "kernel_device",
                        lambda name, *ts: torch.device("cpu"))
    _, (q, k, v) = _inputs(64, 64, 128, 4, 2, "bfloat16")
    with pytest.raises(RuntimeError, match="flash_attention_sm90"):
        tfa_k.flash_attention(q, k, v, block_q=64, block_k=64)


def test_sm90_variant_refuses_what_it_does_not_take():
    _, (q, k, v) = _inputs(64, 64, 32, 4, 2, "bfloat16")
    with pytest.raises(ValueError, match="flash_attention_sm90"):
        tfa_k.flash_attention_sm90(q, k, v, causal=True)


def test_sm90_tiles_are_read_from_the_kernel_source():
    text = (tfa_k._build.CSRC / "flash_attention_sm90.cu").read_text()
    assert f"#define FA9_BM {tfa_k.SM90_BM} " in text
    assert f"#define FA9_BN {SM90_BN} " in text


SM90_BN = tfa_k._build.source_define("flash_attention_sm90", "FA9_BN")


def sm90_key_tiles(q0, sq, sk, causal):
    """The sm90 kernel's schedule for its query tile of ``SM90_BM`` rows
    from ``q0``, as ``csrc/flash_attention_sm90.cu``'s ``fa9_key_tiles``
    and ``edge`` compute it: ``[(k0, masked), ...]``, the key tiles of
    ``SM90_BN`` keys it visits (all, or when causal those up to its last
    row's diagonal) and whether it masks each (a tile that may hold a key
    past ``sk`` or above a row's diagonal)."""
    bm = tfa_k.SM90_BM
    n = -(-sk // SM90_BN)
    if causal:
        n = min(n, (min(q0 + bm, sq) - 1) // SM90_BN + 1)
    return [(k0, k0 + SM90_BN > sk or (causal and k0 + SM90_BN - 1 > q0))
            for k0 in range(0, n * SM90_BN, SM90_BN)]


def _plain_visible(sq, sk, causal):
    """Which keys each query sees, as the plain version masks them: with q
    and k zero every visible key weighs the same, and v the identity makes
    out[i, j] that weight (zero where key j is masked)."""
    q = torch.zeros(1, 1, sq, sk)
    k = torch.zeros(1, 1, sk, sk)
    v = torch.eye(sk)[None, None]
    return tfa_k.flash_attention_plain(q, k, v, causal=causal)[0, 0] > 0


# Sq = Sk, Sq < Sk, Sq > Sk and ragged sizes, off the 128-row tiles
@pytest.mark.parametrize("sq,sk,causal", [
    (256, 256, True), (128, 384, True), (384, 128, True), (96, 160, True),
    (200, 130, True), (130, 333, True), (256, 256, False),
    (96, 160, False)])
def test_sm90_schedule_visits_exactly_the_tiles_with_a_visible_key(sq, sk,
                                                                   causal):
    """Each query tile of the sm90 kernel visits exactly the key tiles that
    hold a key one of its rows sees under the plain version's mask, and
    leaves unmasked only tiles whose every key its every row sees."""
    seen = _plain_visible(sq, sk, causal)
    bm, bn = tfa_k.SM90_BM, SM90_BN
    for q0 in range(0, sq, bm):
        rows = seen[q0:q0 + bm]
        tiles = sm90_key_tiles(q0, sq, sk, causal)
        visited = [k0 for k0, _ in tiles]
        want = [k0 for k0 in range(0, sk, bn)
                if bool(rows[:, k0:k0 + bn].any())]
        assert visited == want
        for k0, masked in tiles:
            block = rows[:, k0:k0 + bn]
            assert masked or (bool(block.all()) and block.shape[1] == bn)


# --------------------------------------------------------------------------- #
# The mma kernel's arithmetic on the CPU: TF32 splits and 3xTF32 products
# --------------------------------------------------------------------------- #
def _tf32_exact(x):
    """float32 values whose low 13 mantissa bits are zero (TF32 values)."""
    return bool(((x.view(torch.int32) & 0x1FFF) == 0).all())


def test_tf32_split_rounds_to_nearest_with_ties_away_from_zero():
    """``cvt.rna.tf32.f32``'s rounding: a TF32 unit at 1.0 is 2**-10, so
    1 + 2**-11 (a tie) rounds away from zero, to 1 + 2**-10, and so does its
    negative; just under the tie rounds down; inf and 0 pass."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0, float("inf")])
    hi, _ = tfa_k.tf32_split(x)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0,
                         float("inf")])
    assert torch.equal(hi, want)


def test_tf32_split_reconstructs_float32_within_2_to_the_minus_21():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(20_000),
        rng.standard_normal(5_000) * 10.0 ** rng.integers(-30, 30, 5_000)])
        .astype(np.float32))
    hi, lo = tfa_k.tf32_split(x)
    assert _tf32_exact(hi) and _tf32_exact(lo)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    # lo is the smaller term: at most half a TF32 unit of hi
    assert bool((lo.abs() <= 2.0 ** -11 * hi.abs()).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tf32_split_of_16_bit_values_has_no_lo(dtype):
    """bf16 and f16 are exact in TF32 (f16's subnormals included), so the
    kernel takes one pass for their products."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal(20_000).astype(np.float32)
                         * 10.0 ** rng.integers(-6, 4, 20_000)).to(dtype)
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
    every = bits.view(dtype)
    for vals in (x, every[torch.isfinite(every.float())]):
        hi, lo = tfa_k.tf32_split(vals)
        assert torch.equal(hi, vals.float())
        assert not bool(lo.any())


def _split_matmul(a, b, passes):
    """``a @ b`` as the mma kernel forms it from TF32 splits: 3 passes
    ``lo·hi + hi·lo + hi·hi`` (the small terms first), 2 ``a_lo·b + a_hi·b``
    (b exact in TF32), 1 ``a·b`` (both exact); each pass a float32 product
    of TF32 values, so exact products summed in float32."""
    a_hi, a_lo = tfa_k.tf32_split(a)
    b_hi, b_lo = tfa_k.tf32_split(b)
    if passes == 1:
        return torch.matmul(a_hi, b_hi)
    if passes == 2:
        return torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + \
        torch.matmul(a_hi, b_hi)


def attention_3xtf32(q, k, v, *, causal, s_passes, pv_passes):
    """:func:`flash_attention_plain`'s arithmetic with its two matmuls
    replaced by the mma kernel's split products (``s_passes`` for Q·Kᵀ,
    ``pv_passes`` for P·V, with P float32)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.float().reshape(b, hkv, group * sq, d)
    s = _split_matmul(qg, k.float().transpose(-1, -2), s_passes)
    s = (s * (1.0 / d ** 0.5)).view(b, hkv, group, sq, sk)
    if causal:
        mask = torch.arange(sq)[:, None] < torch.arange(sk)[None, :]
        s = s.masked_fill(mask, tfa_k.NEG_INF)
    p = torch.softmax(s, dim=-1).view(b, hkv, group * sq, sk)
    out = _split_matmul(p, v.float(), pv_passes)
    return out.view(b, hq, sq, d).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,d,causal,hq,hkv", CASES)
def test_3xtf32_attention_matches_the_pallas_kernel(sq, sk, d, causal, hq,
                                                    hkv, dtype):
    """The mma kernel's passes by dtype (float32: 3 and 3; 16-bit: 1 and 2)
    keep JAX's contract: within the float32 tolerance of 1e-5 in float32,
    one rounding of the output in bfloat16."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq, sk, d, hq, hkv, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=BLOCK,
                                block_k=BLOCK)
    passes = (3, 3) if dtype == "float32" else (1, 2)
    got = attention_3xtf32(tq, tk, tv, causal=causal, s_passes=passes[0],
                           pv_passes=passes[1])
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_one_tf32_pass_would_miss_the_float32_tolerance():
    """The split is needed: plain TF32 products (raw operands rounded once)
    miss JAX's float32 kernel by more than 1e-5 on the same inputs."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(128, 128, 64, 4, 2, "float32")
    want = _f32(jops.flash_attention(jq, jk, jv, causal=True, block_q=BLOCK,
                                     block_k=BLOCK))
    got = attention_3xtf32(tq, tk, tv, causal=True, s_passes=1,
                           pv_passes=1)
    assert np.abs(_f32(got) - want).max() > 1e-5
