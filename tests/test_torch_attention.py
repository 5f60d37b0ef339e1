"""The port's attention wrappers (``repro_torch.kernels.attention``, plain
versions on the CPU) against the reference's Pallas kernels in interpret
mode (``repro.kernels.ops``) and its oracles (``repro.kernels.ref``), on
the reference test's own cases (tests/test_kernels.py) plus bf16,
masked-row and all-masked-row cases.  Inputs come from a numpy seed and
reach both packages as the same float32 (or bf16-rounded) values.

Tolerances are the reference test's: decode 2e-5 in f32 and 2e-2 in
bf16, flash 2e-4 in f32 and 3e-2 in bf16 (f32 sums in another order; bf16
outputs round at other places)."""
import jax  # noqa: F401  (both packages in one process, data as numpy)
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.kernels import attention as t_att  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounded to
    nearest even by both)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------- decode attn

@pytest.mark.parametrize("b,h,kvh,hd,t", [
    (2, 8, 8, 64, 1024), (2, 8, 2, 64, 1024), (1, 16, 4, 128, 2048),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(b, h, kvh, hd, t, dtype):
    r = np.random.default_rng(b * h + kvh + t)
    jq, tq = both(r.standard_normal((b, h, hd), np.float32), dtype)
    jk, tk = both(r.standard_normal((b, t, kvh, hd), np.float32), dtype)
    jv, tv = both(r.standard_normal((b, t, kvh, hd), np.float32), dtype)
    valid = r.random((b, t)) < 0.9
    t_att.reset_launches()
    got = t_ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    assert t_att.plain_runs["decode_attention"] == 1
    assert t_att.launches["decode_attention"] == 0
    assert got.dtype == torch.float32 and got.shape == (b, h, hd)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (j_ops.decode_attention(jq, jk, jv, jnp.asarray(valid)),
                 j_ref.decode_attention(jq, jk, jv, jnp.asarray(valid))):
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def test_decode_attention_respects_mask():
    """All but one position masked: the output is that position's v (the
    reference's own case)."""
    b, h, kvh, hd, t = 1, 4, 4, 64, 512
    r = np.random.default_rng(1)
    q = np.ones((b, h, hd), np.float32)
    k = r.standard_normal((b, t, kvh, hd), np.float32)
    v = r.standard_normal((b, t, kvh, hd), np.float32)
    valid = np.zeros((b, t), bool)
    valid[:, 137] = True
    got = t_ops.decode_attention(*(torch.from_numpy(x)
                                   for x in (q, k, v, valid)))
    np.testing.assert_allclose(f32(got), v[:, 137].reshape(b, h, hd),
                               rtol=1e-5, atol=1e-5)
    want = j_ops.decode_attention(*(jnp.asarray(x) for x in (q, k, v, valid)))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


def test_decode_attention_all_masked_row_is_the_mean_of_v():
    """A row with no valid key: every logit is -2e38, the softmax is
    uniform, and the output is the mean of v over all T keys, in the
    reference's Pallas kernel, its oracle and the port alike."""
    b, h, kvh, hd, t = 2, 4, 2, 32, 512
    r = np.random.default_rng(2)
    q, k, v = (r.standard_normal(s, np.float32)
               for s in ((b, h, hd), (b, t, kvh, hd), (b, t, kvh, hd)))
    valid = r.random((b, t)) < 0.5
    valid[1] = False
    got = f32(t_ops.decode_attention(*(torch.from_numpy(x)
                                       for x in (q, k, v, valid))))
    mean = np.repeat(v[1].mean(axis=0), h // kvh, axis=0)     # (h, hd)
    np.testing.assert_allclose(got[1], mean, rtol=1e-5, atol=1e-5)
    args = [jnp.asarray(x) for x in (q, k, v, valid)]
    for want in (j_ops.decode_attention(*args),
                 j_ref.decode_attention(*args)):
        np.testing.assert_allclose(got, f32(want), rtol=2e-5, atol=2e-5)


def test_decode_attention_takes_a_broadcast_mask_and_any_length():
    """``valid`` as an expanded view of a (T,) mask, and T that is no
    multiple of the reference's tile (its assert is tiling, not
    semantics): held to the oracle."""
    b, h, kvh, hd, t = 3, 8, 2, 16, 77
    r = np.random.default_rng(3)
    q, k, v = (r.standard_normal(s, np.float32)
               for s in ((b, h, hd), (b, t, kvh, hd), (b, t, kvh, hd)))
    pos_valid = torch.from_numpy(r.random(t) < 0.6)
    got = t_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 pos_valid[None].expand(b, t))
    want = j_ref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  jnp.broadcast_to(
                                      jnp.asarray(pos_valid.numpy()), (b, t)))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ flash attn

FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, 64, True, 0, 0.0),      # GQA causal
    (1, 200, 200, 4, 4, 32, 32, True, 0, 50.0),     # softcap + ragged seq
    (2, 128, 384, 2, 1, 64, 32, False, 0, 0.0),     # cross-attn, MLA v-dim
    (1, 256, 256, 8, 2, 64, 64, True, 96, 0.0),     # sliding window
]


@pytest.mark.parametrize("b,s,t,h,kv,hd,hdv,causal,window,cap", FLASH_CASES)
def test_flash_attention_matches_reference(b, s, t, h, kv, hd, hdv, causal,
                                           window, cap):
    r = np.random.default_rng(7)
    q = r.standard_normal((b, s, h, hd), np.float32)
    k = r.standard_normal((b, t, kv, hd), np.float32)
    v = r.standard_normal((b, t, kv, hdv), np.float32)
    kw = dict(causal=causal, window=window, softcap=cap)
    t_att.reset_launches()
    got = t_ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                **kw)
    assert t_att.plain_runs["flash_attention"] == 1
    assert got.dtype == torch.float32 and got.shape == (b, s, h, hdv)
    args = [jnp.asarray(x) for x in (q, k, v)]
    for want in (j_ops.flash_attention(*args, **kw),
                 j_ref.flash_attention(*args, **kw)):
        np.testing.assert_allclose(f32(got), f32(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 40)])
def test_flash_attention_bf16(causal, window):
    r = np.random.default_rng(8)
    jq, tq = both(r.standard_normal((1, 128, 4, 64), np.float32), "bfloat16")
    jk, tk = both(r.standard_normal((1, 128, 2, 64), np.float32), "bfloat16")
    jv, tv = both(r.standard_normal((1, 128, 2, 64), np.float32), "bfloat16")
    got = t_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    for want in (j_ops.flash_attention(jq, jk, jv, causal=causal,
                                       window=window),
                 j_ref.flash_attention(jq, jk, jv, causal=causal,
                                       window=window)):
        np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)


def test_flash_attention_gqa_head_order():
    """Head h reads KV head h // G: with 4 query heads on 2 KV heads whose
    values differ, heads 0-1 and 2-3 see different values.  A mapping of
    h to h % KV would pass with KV == H; here it would not."""
    r = np.random.default_rng(9)
    q = r.standard_normal((1, 16, 4, 8), np.float32)
    k = r.standard_normal((1, 16, 2, 8), np.float32)
    v = r.standard_normal((1, 16, 2, 8), np.float32)
    v[..., 1, :] += 10.0
    got = f32(t_ops.flash_attention(*(torch.from_numpy(x)
                                      for x in (q, k, v))))
    want = f32(j_ref.flash_attention(*(jnp.asarray(x) for x in (q, k, v))))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert (got[:, :, 2:] > 5).all() and (got[:, :, :2] < 5).all()


def test_flash_attention_all_masked_row_follows_the_oracle():
    """Causal with a window and T < S leaves the last queries no key: the
    port gives those rows the mean of v over the T keys, as the oracle
    ``ref.flash_attention`` does.  The Pallas kernel also averages over the
    zero keys it pads T with (to 128), so it differs on those rows only
    (ROADMAP §C)."""
    b, s, t, h, kv, hd = 1, 8, 4, 2, 1, 16
    r = np.random.default_rng(10)
    q = r.standard_normal((b, s, h, hd), np.float32)
    k = r.standard_normal((b, t, kv, hd), np.float32)
    v = r.standard_normal((b, t, kv, hd), np.float32)
    kw = dict(causal=True, window=2)
    got = f32(t_ops.flash_attention(*(torch.from_numpy(x)
                                      for x in (q, k, v)), **kw))
    args = [jnp.asarray(x) for x in (q, k, v)]
    np.testing.assert_allclose(got, f32(j_ref.flash_attention(*args, **kw)),
                               rtol=2e-4, atol=2e-4)
    empty = slice(5, None)              # rows 5-7: keys (i - 2, i] miss [0, 4)
    np.testing.assert_allclose(got[0, empty], np.broadcast_to(
        v[0].mean(axis=0), (s - 5, h, hd)), rtol=1e-5, atol=1e-5)
    pallas = f32(j_ops.flash_attention(*args, **kw))
    np.testing.assert_allclose(got[0, :5], pallas[0, :5], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(pallas[0, empty], got[0, empty] * t / 128,
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------- chunk choice and padding

H100_SMS = 132                  # multiprocessors of an H100 SXM


@pytest.mark.parametrize("t,pairs,group", [
    (1088, 64, 4),               # the serving path: qwen3-4b
    (4096, 128, 2),              # gemma3-27b's decode
    (1, 8, 8), (77, 4, 7), (8192, 32, 4), (8192, 2, 1), (300, 3, 64),
    (65, 1, 2), (100_000, 1024, 4), (1025, 16, 1),
])
def test_decode_chunk_fills_the_card(t, pairs, group):
    """The chunk is a multiple of 16 in [16, 256], keeps the chunk's
    logits within 32 KB, and splits T into enough chunks for 2 blocks an
    SM unless the chunk is already at its floor of 16 or its cap."""
    chunk = t_att.decode_chunk(t, pairs, group, H100_SMS)
    assert chunk % 16 == 0 and 16 <= chunk <= t_att.DECODE_MAX_CHUNK
    assert 4 * group * chunk <= 32 * 1024
    cap = min(t_att.DECODE_MAX_CHUNK, 8192 // group // 16 * 16)
    blocks = -(-t // chunk) * pairs
    assert blocks >= 2 * H100_SMS or chunk in (16, cap)


def test_decode_chunk_on_the_serving_paths():
    """qwen3-4b's decode (B 8 x KV 8, G 4, T 1088): 208-key chunks, 6 a
    sequence and KV head, 384 blocks; gemma3-27b's (B 8 x KV 16, G 2, T
    4096): 256-key chunks, 2048 blocks; T = 1 and short caches: 16."""
    assert t_att.decode_chunk(1088, 64, 4, H100_SMS) == 208
    assert t_att.decode_chunk(4096, 128, 2, H100_SMS) == 256
    assert t_att.decode_chunk(1, 64, 4, H100_SMS) == 16
    assert t_att.decode_chunk(77, 4, 4, H100_SMS) == 16


@pytest.mark.parametrize("hd,hdv", [(40, 40), (20, 24), (100, 72), (64, 8),
                                    (1, 1)])
def test_head_dim_padding_changes_nothing(hd, hdv):
    """Zero columns padded onto q, k and v (to a multiple of 16, as the
    wrappers do before a launch) leave every dot product as it was: the
    plain versions on the padded tensors, with the unpadded head dim's
    scale and the output sliced back, equal the unpadded calls."""
    r = np.random.default_rng(hd * 7 + hdv)
    b, s, t, h, kv = 2, 24, 40, 6, 3
    q = torch.from_numpy(r.standard_normal((b, s, h, hd), np.float32))
    k = torch.from_numpy(r.standard_normal((b, t, kv, hd), np.float32))
    v = torch.from_numpy(r.standard_normal((b, t, kv, hdv), np.float32))
    pq, pk, pv = (t_att.pad_head_dim(x) for x in (q, k, v))
    assert pq.shape[-1] % 16 == 0 and pv.shape[-1] % 16 == 0
    assert pq.shape[-1] - hd < 16 and pq.is_contiguous()
    assert torch.equal(pq[..., :hd], q) and not pq[..., hd:].any()
    for kw in (dict(causal=True), dict(causal=False, window=9, softcap=5.0)):
        want = t_att.flash_attention_plain(q, k, v, **kw)
        got = t_att.flash_attention_plain(pq, pk, pv, scale=hd ** -0.5,
                                          **kw)[..., :hdv]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # decode takes v of q's head dim; its scale is the unpadded hd's
    vd = torch.from_numpy(r.standard_normal((b, t, kv, hd), np.float32))
    valid = torch.from_numpy(r.random((b, t)) < 0.7)
    want = t_att.decode_attention_plain(q[:, 0].contiguous(), k, vd, valid)
    pqd = t_att.pad_head_dim(q[:, 0])
    logits = torch.einsum("bngd,btnd->bngt",
                          pqd.reshape(b, kv, h // kv, -1), pk) * hd ** -0.5
    logits = torch.where(valid[:, None, None, :], logits, t_att.NEG)
    got = torch.einsum("bngt,btnd->bngd", torch.softmax(logits, -1),
                       t_att.pad_head_dim(vd)).reshape(b, h, -1)[..., :hd]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert t_att.pad_head_dim(pq) is pq or torch.equal(
        t_att.pad_head_dim(pq), pq)


# ------------------------------------------------------- wrapper checks

def test_wrappers_check_their_arguments():
    q = torch.zeros((2, 8, 16))
    k = torch.zeros((2, 10, 2, 16))
    valid = torch.ones((2, 10), dtype=torch.bool)
    with pytest.raises(TypeError, match="dtype"):
        t_ops.decode_attention(q.double(), k.double(), k.double(), valid)
    with pytest.raises(TypeError, match="dtype"):
        t_ops.decode_attention(q, k.bfloat16(), k, valid)
    with pytest.raises(ValueError, match="group"):
        t_ops.decode_attention(torch.zeros((2, 7, 16)), k, k, valid)
    with pytest.raises(ValueError, match="valid"):
        t_ops.decode_attention(q, k, k, valid[:, :9])
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.decode_attention(q, k.transpose(0, 1).contiguous()
                               .transpose(0, 1), k, valid)
    with pytest.raises(ValueError, match="T >= 1"):
        t_ops.decode_attention(q, k[:, :0], k[:, :0], valid[:, :0])
    q4 = torch.zeros((2, 5, 8, 16))
    with pytest.raises(ValueError, match="head dims"):
        t_ops.flash_attention(torch.zeros((1, 2, 2, 512)),
                              torch.zeros((1, 2, 2, 512)),
                              torch.zeros((1, 2, 2, 512)))
    with pytest.raises(ValueError, match="window"):
        t_ops.flash_attention(q4, k, k, window=-1)
    with pytest.raises(ValueError, match="batch"):
        t_ops.flash_attention(q4[:1], k, k)
    ok, detail = t_att.supported()
    assert isinstance(ok, bool) and detail
