"""The port's kernel modules against the JAX package's kernels.

For each of K1 (LayerNorm forward), K2 (contiguous decode attention) and
K3 (paged decode attention), the port's plain PyTorch version is held
against the JAX function on the same numpy inputs made from a seed. The
JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode; so is the split-and-merge arithmetic of the one CUDA
kernel behind K2 and K3 (`decode_split_model`, `paged_decode_split_model`),
at several split sizes on each layout. Tolerances:
float32 at rtol = atol = 2e-5, the JAX suite's
own bound for its decode kernels (tests/test_serving.py); bfloat16 at
2e-2, since the two frameworks round bf16 at different points.

On CPU tensors every wrapper takes its plain version and leaves its kernel
launch count at 0; on a CUDA tensor it launches the kernel. The kernels
themselves run only on the card: tests/test_torch_cuda.py holds each one
against its plain version there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.layer_norm import fused_layer_norm_or_none
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import layer_norm as tln
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the JAX kernels package re-exports a function named flash_attention
jfa = importlib.import_module("flexflow_tpu.kernels.flash_attention")

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

DTYPES = {
    "f32": (torch.float32, jnp.float32, F32_TOL),
    "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL),
}

# the decode edge cases of chip_smoke.py's parity phase, at a small size:
# an empty slot, one key, a block boundary on either side, a partial
# block and a full cache
LENGTHS = [0, 1, 15, 16, 17, 200, 256]
S, H, HD, BS = 256, 2, 64, 16
E = H * HD


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ------------------------------------------------------------------- K1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 128), (64, 256), (16, 1024)])
def test_layer_norm_plain_matches_jax_kernel(shape, dtype):
    """K1's plain version vs the JAX Pallas LayerNorm forward (interpret
    mode) on shapes its gate tiles; scale/bias in the activation dtype,
    as the executor's compute cast hands them to the op."""
    tdt, jdt, tol = DTYPES[dtype]
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
    scale = rs.randn(shape[-1]).astype(np.float32)
    bias = rs.randn(shape[-1]).astype(np.float32)
    want = fused_layer_norm_or_none(
        jnp.asarray(x, jdt), jnp.asarray(scale, jdt),
        jnp.asarray(bias, jdt), (1,), 1e-5)
    assert want is not None, "shape must take the JAX fused kernel"
    got = tln.layer_norm_plain(torch.tensor(x).to(tdt),
                               torch.tensor(scale).to(tdt),
                               torch.tensor(bias).to(tdt), 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def test_layer_norm_wrapper_takes_plain_on_cpu():
    rs = np.random.RandomState(1)
    x = torch.tensor(rs.randn(3, 5, 40).astype(np.float32))
    s = torch.tensor(rs.randn(40).astype(np.float32))
    b = torch.tensor(rs.randn(40).astype(np.float32))
    c = tln.LAYER_NORM_COUNTER
    c.reset()
    y = tln.layer_norm(x, s, b, 1e-5)
    assert (c.launches, c.plain_calls) == (0, 1)
    torch.testing.assert_close(y, tln.layer_norm_plain(x, s, b, 1e-5))
    c.reset()


# ------------------------------------------------------------------- K2


def _decode_inputs(seed, lengths=LENGTHS, seq=S):
    """q, k, v with NaN planted in every cache row past each slot's
    length: the kernels must never read a dead row into the output."""
    rs = np.random.RandomState(seed)
    slots = len(lengths)
    q = rs.randn(slots, 1, E).astype(np.float32)
    k = rs.randn(slots, seq, E).astype(np.float32)
    v = rs.randn(slots, seq, E).astype(np.float32)
    for s, n in enumerate(lengths):
        k[s, n:] = np.nan
        v[s, n:] = np.nan
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_plain_matches_jax_kernel(dtype):
    """K2's plain version vs the JAX single-query decode kernel (interpret
    mode, two kv blocks so its online softmax and dead-block skip run).
    The JAX op casts the f32 cache to the compute dtype before the
    kernel; the port hands it the f32 cache and rounds on use."""
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, lengths = _decode_inputs(0)
    want = jfa.flash_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(lengths), num_heads=H, block_k=128, interpret=True)
    got = tfa.decode_attention_plain(
        torch.tensor(q).to(tdt), torch.tensor(k), torch.tensor(v),
        torch.tensor(lengths), num_heads=H)
    assert got.dtype == tdt and np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def test_decode_plain_matches_jax_reference():
    """K2's plain version vs the einsum oracle (finite cache: the oracle,
    unlike the kernels, multiplies dead V rows by a zero probability)."""
    q, k, v, lengths = _decode_inputs(1)
    k, v = np.nan_to_num(k), np.nan_to_num(v)
    live = lengths > 0  # the oracle spreads an empty slot's row uniformly
    want = jfa.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths - 1)[:, None], num_heads=H)
    got = tfa.decode_attention_plain(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), torch.tensor(lengths),
                                     num_heads=H)
    np.testing.assert_allclose(_np(got)[live], np.asarray(want)[live],
                               **F32_TOL)


def test_decode_wrapper_takes_plain_on_cpu():
    q, k, v, lengths = _decode_inputs(2)
    c = tfa.DECODE_COUNTER
    c.reset()
    out = tfa.flash_decode_attention(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), torch.tensor(lengths),
                                     num_heads=H)
    assert (c.launches, c.plain_calls) == (0, 1)
    assert out.shape == (len(LENGTHS), 1, E)
    with pytest.raises(ValueError, match="single-query"):
        tfa.flash_decode_attention(torch.zeros(2, 3, E), torch.tensor(k),
                                   torch.tensor(v), torch.tensor(lengths),
                                   num_heads=H)
    c.reset()


# ------------------------------------------------------------------- K3


def _paged_inputs(seed):
    """A scrambled page table, two slots sharing every block, unmapped
    entries on the scratch block 0, and NaN in every pool row no slot
    reads (stale rows, the rest of the scratch block)."""
    rs = np.random.RandomState(seed)
    slots, W = len(LENGTHS), S // BS
    nb = slots * W + 1
    table = np.zeros((slots, W), np.int32)
    perm = rs.permutation(np.arange(1, nb))
    for s, n in enumerate(LENGTHS):
        used = -(-n // BS)
        table[s, :used] = perm[s * W:s * W + used]
    table[5] = table[6]  # slot 5 shares slot 6's blocks (prefix reuse)
    pool_k = rs.randn(nb, BS, E).astype(np.float32)
    pool_v = rs.randn(nb, BS, E).astype(np.float32)
    live = np.zeros((nb, BS), bool)
    for s, n in enumerate(LENGTHS):
        for r in range(n):
            live[table[s, r // BS], r % BS] = True
    pool_k[~live] = np.nan
    pool_v[~live] = np.nan
    q = rs.randn(slots, 1, E).astype(np.float32)
    return q, pool_k, pool_v, table, np.asarray(LENGTHS, np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_decode_plain_matches_jax_kernel(dtype):
    """K3's plain version vs the JAX paged decode kernel (interpret mode,
    kv grid walking the page table)."""
    tdt, jdt, tol = DTYPES[dtype]
    q, pk, pv, table, lengths = _paged_inputs(0)
    want = jfa.paged_flash_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
        jnp.asarray(table), jnp.asarray(lengths), num_heads=H,
        interpret=True)
    got = tfa.paged_decode_attention_plain(
        torch.tensor(q).to(tdt), torch.tensor(pk), torch.tensor(pv),
        torch.tensor(table), torch.tensor(lengths), num_heads=H)
    assert got.dtype == tdt and np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def test_paged_decode_plain_matches_jax_reference():
    q, pk, pv, table, lengths = _paged_inputs(1)
    pk, pv = np.nan_to_num(pk), np.nan_to_num(pv)
    live = lengths > 0
    want = jfa.paged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), jnp.asarray(lengths - 1)[:, None], num_heads=H)
    got = tfa.paged_decode_attention_plain(
        torch.tensor(q), torch.tensor(pk), torch.tensor(pv),
        torch.tensor(table), torch.tensor(lengths), num_heads=H)
    np.testing.assert_allclose(_np(got)[live], np.asarray(want)[live],
                               **F32_TOL)


def test_paged_decode_wrapper_takes_plain_on_cpu():
    q, pk, pv, table, lengths = _paged_inputs(2)
    c = tfa.PAGED_DECODE_COUNTER
    c.reset()
    out = tfa.paged_flash_decode_attention(
        torch.tensor(q), torch.tensor(pk), torch.tensor(pv),
        torch.tensor(table), torch.tensor(lengths), num_heads=H)
    assert (c.launches, c.plain_calls) == (0, 1)
    assert np.isfinite(_np(out)).all()
    bad = table.copy()
    bad[0, 0] = pk.shape[0]  # a block past the pool
    with pytest.raises(IndexError):
        tfa.paged_flash_decode_attention(
            torch.tensor(q), torch.tensor(pk), torch.tensor(pv),
            torch.tensor(bad), torch.tensor(lengths), num_heads=H)
    c.reset()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_plain_rounds_a_halfway_cache_as_jax(layout):
    """bfloat16 over a float32 cache whose K/V values lie halfway between
    bfloat16 values (chip_smoke.halfway_inputs). The plain version matches
    the JAX kernel, which casts the whole cache before it reads it; and the
    case sees each rounding: the same arithmetic with K or with V left
    unrounded lands beyond the tolerance. tests/test_torch_cuda.py holds
    the kernels to the plain version on this case, so a kernel that skips
    the rounding on load fails there."""
    import chip_smoke

    lengths = [0, 1, 2, 17, 200, 256]
    q, k, v, lens = chip_smoke.halfway_inputs(lengths, S, H, HD, 5)
    qb = q.bfloat16()
    if layout == "paged":
        pk, pv, table = chip_smoke.pooled(k, v, lens, BS, 6)
        want = jfa.paged_flash_decode_attention(
            jnp.asarray(q.numpy(), jnp.bfloat16),
            jnp.asarray(pk.numpy(), jnp.bfloat16),
            jnp.asarray(pv.numpy(), jnp.bfloat16), jnp.asarray(table.numpy()),
            jnp.asarray(lens.numpy()), num_heads=H, interpret=True)

        def plain(q, k, v):
            return tfa.paged_decode_attention_plain(q, k, v, table, lens,
                                                    num_heads=H)

        k_, v_ = pk, pv
    else:
        want = jfa.flash_decode_attention(
            jnp.asarray(q.numpy(), jnp.bfloat16),
            jnp.asarray(k.numpy(), jnp.bfloat16),
            jnp.asarray(v.numpy(), jnp.bfloat16), jnp.asarray(lens.numpy()),
            num_heads=H, block_k=128, interpret=True)

        def plain(q, k, v):
            return tfa.decode_attention_plain(q, k, v, lens, num_heads=H)

        k_, v_ = k, v
    got = plain(qb, k_, v_)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_TOL)
    rounded = lambda t: t.bfloat16().float()  # noqa: E731
    k_only = plain(q, k_, rounded(v_))  # f32 q: K and P left unrounded
    v_only = plain(q, rounded(k_), v_)  # V and P left unrounded
    for unrounded in (k_only, v_only):
        assert not np.allclose(_np(unrounded), _np(got), **BF16_TOL)


def test_multi_query_references_match_jax():
    """The multi-query path (prefill chunks) is plain torch in the port,
    as the einsum is in the JAX package on every backend."""
    rs = np.random.RandomState(3)
    slots, q_len = 3, 4
    q = rs.randn(slots, q_len, E).astype(np.float32)
    k = rs.randn(slots, S, E).astype(np.float32)
    v = rs.randn(slots, S, E).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3], [10, 11, 12, 13], [-1, 252, 254, 255]],
                     np.int32)
    want = jfa.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        num_heads=H)
    got = tfa.decode_attention_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(pos), num_heads=H)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


# ------------------------------------------------ K3's split-and-merge


def _pages_per_split(pages):
    return S // BS if pages == "W" else pages


@pytest.mark.parametrize("pages", [1, 2, "W"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_split_model_matches_jax_kernel(dtype, pages):
    """The CUDA K3's arithmetic (`paged_decode_split_model`: partials per
    split of 1, 2 or all W pages, p rounded against the split's max, the
    splits merged in order) vs the JAX paged decode kernel (interpret
    mode) on the decode edge cases: an empty slot, one key, both sides of
    a page boundary, shared pages, NaN in every row no slot reads. The
    tolerances are the module's: 2e-5 float32, 2e-2 bfloat16 (P rounded
    against another max than the JAX kernel's running one)."""
    tdt, jdt, tol = DTYPES[dtype]
    q, pk, pv, table, lengths = _paged_inputs(3)
    want = jfa.paged_flash_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
        jnp.asarray(table), jnp.asarray(lengths), num_heads=H,
        interpret=True)
    got = tfa.paged_decode_split_model(
        torch.tensor(q).to(tdt), torch.tensor(pk), torch.tensor(pv),
        torch.tensor(table), torch.tensor(lengths), num_heads=H,
        keys_per_split=_pages_per_split(pages) * BS)
    assert got.dtype == tdt and np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("pages", [1, 2, "W"])
def test_paged_split_model_rounds_a_halfway_cache_as_jax(pages):
    """bfloat16 over the float32 cache of values halfway between bfloat16
    values (chip_smoke.halfway_inputs): the split model, which rounds K
    and V as it reads them, matches the JAX kernel, which casts the whole
    cache first, at 2e-2."""
    import chip_smoke

    lengths = [0, 1, 2, 17, 200, 256]
    q, k, v, lens = chip_smoke.halfway_inputs(lengths, S, H, HD, 5)
    pk, pv, table = chip_smoke.pooled(k, v, lens, BS, 6)
    want = jfa.paged_flash_decode_attention(
        jnp.asarray(q.numpy(), jnp.bfloat16),
        jnp.asarray(pk.numpy(), jnp.bfloat16),
        jnp.asarray(pv.numpy(), jnp.bfloat16), jnp.asarray(table.numpy()),
        jnp.asarray(lens.numpy()), num_heads=H, interpret=True)
    got = tfa.paged_decode_split_model(
        q.bfloat16(), pk, pv, table, lens, num_heads=H,
        keys_per_split=_pages_per_split(pages) * BS)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_TOL)


# ------------------------------------------------ K2's split-and-merge

# a cache of 200 keys, no multiple of the splits below; lengths 0, 1 and S
# beside both sides of a 16-key and a 128-key boundary
S_RAGGED = 200
LENGTHS_RAGGED = [0, 1, 15, 16, 17, 127, 129, S_RAGGED]


def _keys_per_split(kps):
    return S_RAGGED if kps == "S" else kps


@pytest.mark.parametrize("kps", [7, 32, "S"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_contiguous_split_model_matches_jax_kernel(dtype, kps):
    """The CUDA K2's arithmetic (`decode_split_model`: partials per split
    of 7, 32 (the kernel's own at head_dim 64) or all S keys, the last
    split short, p rounded against the split's max, the splits merged in
    order) vs the JAX single-query decode kernel (interpret mode, two kv
    blocks, the second one ragged) over a cache with NaN in every row past
    each length. The tolerances are the module's."""
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, lengths = _decode_inputs(4, LENGTHS_RAGGED, S_RAGGED)
    want = jfa.flash_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(lengths), num_heads=H, block_k=128, interpret=True)
    got = tfa.decode_split_model(
        torch.tensor(q).to(tdt), torch.tensor(k), torch.tensor(v),
        torch.tensor(lengths), num_heads=H,
        keys_per_split=_keys_per_split(kps))
    assert got.dtype == tdt and np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("kps", [7, 32, "S"])
def test_contiguous_split_model_rounds_a_halfway_cache_as_jax(kps):
    """bfloat16 over the float32 cache of values halfway between bfloat16
    values (chip_smoke.halfway_inputs), S no multiple of the split: the
    split model, which rounds K and V as it reads them, matches the JAX
    kernel, which casts the whole cache first, at 2e-2; the same
    arithmetic with K or with V left unrounded does not."""
    import chip_smoke

    lengths = [0, 1, 2, 17, 130, S_RAGGED]
    q, k, v, lens = chip_smoke.halfway_inputs(lengths, S_RAGGED, H, HD, 5)
    want = jfa.flash_decode_attention(
        jnp.asarray(q.numpy(), jnp.bfloat16),
        jnp.asarray(k.numpy(), jnp.bfloat16),
        jnp.asarray(v.numpy(), jnp.bfloat16), jnp.asarray(lens.numpy()),
        num_heads=H, block_k=128, interpret=True)

    def model(q, k, v):
        return tfa.decode_split_model(q, k, v, lens, num_heads=H,
                                      keys_per_split=_keys_per_split(kps))

    got = model(q.bfloat16(), k, v)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_TOL)
    rounded = lambda t: t.bfloat16().float()  # noqa: E731
    for unrounded in (model(q, k, rounded(v)), model(q, rounded(k), v)):
        assert not np.allclose(_np(unrounded), _np(got), **BF16_TOL)


def test_split_models_clamp_the_cursor_to_the_cache():
    """A length past the cache's extent reads the whole cache, as the
    kernel clamps it (and as the plain version's mask does); the paged
    model is the contiguous one over the gathered view."""
    q, k, v, lengths = _decode_inputs(6, [S_RAGGED] * 2, S_RAGGED)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v))
    full = tfa.decode_split_model(*args, torch.tensor(lengths), num_heads=H,
                                  keys_per_split=32)
    past = tfa.decode_split_model(*args, torch.tensor([S_RAGGED + 5, 10 ** 6]),
                                  num_heads=H, keys_per_split=32)
    torch.testing.assert_close(past, full, rtol=0, atol=0)
    torch.testing.assert_close(
        full, tfa.decode_attention_plain(*args, torch.tensor(lengths),
                                         num_heads=H), **F32_TOL)
