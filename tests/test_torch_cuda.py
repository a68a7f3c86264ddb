"""The port's kernels on the card, each against its plain PyTorch version.

Needs an NVIDIA GPU (sm_90a for the CUDA kernels), nvcc and triton; skips
without a CUDA device. This file imports neither jax nor the JAX package,
so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

The tolerances are chip_smoke.py's. Its kernel-parity phase covers the
main path's shapes (NaN in every cache row no slot may read, a scrambled
page table with shared blocks, float32 and bfloat16, and a float32 cache of
values halfway between bfloat16 values, which only a kernel that rounds K
and V on load matches in bfloat16); the tests below add
shapes off that path, which the kernels take all the same.
"""

import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _tol(dtype):
    """chip_smoke.py's kernel-vs-plain tolerance for this dtype."""
    import chip_smoke

    return chip_smoke.TOL[str(dtype).split(".")[1]]


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda):
    import chip_smoke

    errs = chip_smoke.kernel_parity(cuda)
    assert set(errs) == {"layer_norm_fwd", "flash_decode_attention",
                         "paged_flash_decode_attention"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width", [(3, 1000), (5, 10000)])
def test_layer_norm_kernel_off_the_main_path_shapes(cuda, rows, width,
                                                   dtype):
    """A width that is no power of two (masked tail of the one block) and
    one past the single-block limit (the three-pass loop)."""
    from flexflow_tpu_torch.kernels import layer_norm as ln

    g = torch.Generator().manual_seed(width)
    x = (torch.randn(rows, width, generator=g) * 3 + 1).to(cuda, dtype)
    s = torch.randn(width, generator=g).to(cuda)
    b = torch.randn(width, generator=g).to(cuda)
    n0 = ln.LAYER_NORM_COUNTER.launches
    got = ln.layer_norm(x, s, b, 1e-5)
    torch.cuda.synchronize()
    assert ln.LAYER_NORM_COUNTER.launches == n0 + 1
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(),
                               ln.layer_norm_plain(x, s, b, 1e-5).float(),
                               **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim,block", [(32, 5), (80, 16), (128, 8),
                                            (256, 3)])
def test_decode_kernels_off_the_main_path_shapes(cuda, head_dim, block,
                                                 dtype):
    """Every head size the kernel instantiates (one to eight dims per
    lane, 80 leaving lanes idle) and block sizes that are no power of
    two, over a f32 cache with NaN in every row past the cursor."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    heads, seq = 3, 50
    lengths = [0, 1, 7, 23, 50]
    e = heads * head_dim
    n = len(lengths)
    g = torch.Generator().manual_seed(head_dim)
    q = torch.randn(n, 1, e, generator=g).to(cuda, dtype)
    k = torch.randn(n, seq, e, generator=g)
    v = torch.randn(n, seq, e, generator=g)
    for s, length in enumerate(lengths):
        k[s, length:] = float("nan")
        v[s, length:] = float("nan")
    k, v = k.to(cuda), v.to(cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    tol = _tol(dtype)

    got = fa.flash_decode_attention(q, k, v, lens, num_heads=heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(),
        fa.decode_attention_plain(q, k, v, lens, num_heads=heads).float(),
        **tol)

    # the same logical caches in a pool, blocks handed out in reverse
    W = -(-seq // block)
    nb = n * W + 1
    table = torch.zeros(n, W, dtype=torch.int32)
    pool_k = torch.full((nb, block, e), float("nan"))
    pool_v = torch.full((nb, block, e), float("nan"))
    kc, vc = k.cpu(), v.cpu()
    for s, length in enumerate(lengths):
        for j in range(-(-length // block)):
            phys = nb - 1 - (s * W + j)
            table[s, j] = phys
            rows = min(block, length - j * block)
            pool_k[phys, :rows] = kc[s, j * block:j * block + rows]
            pool_v[phys, :rows] = vc[s, j * block:j * block + rows]
    pool_k, pool_v, table = pool_k.to(cuda), pool_v.to(cuda), table.to(cuda)
    paged = fa.paged_flash_decode_attention(q, pool_k, pool_v, table, lens,
                                            num_heads=heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        paged.float(),
        fa.paged_decode_attention_plain(q, pool_k, pool_v, table, lens,
                                        num_heads=heads).float(), **tol)
    # one arithmetic over two layouts: the same keys give the same output
    torch.testing.assert_close(paged.float(), got.float(), **tol)


@pytest.mark.cuda
def test_wrappers_raise_on_what_kernels_do_not_take(cuda):
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    q = torch.zeros(2, 1, 64, device=cuda, dtype=torch.float64)
    kv = torch.zeros(2, 8, 64, device=cuda, dtype=torch.float64)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_decode_attention(q, kv, kv, lengths, num_heads=1)
    with pytest.raises(TypeError):
        ln.layer_norm(q, torch.ones(64, device=cuda, dtype=torch.float64),
                      torch.zeros(64, device=cuda, dtype=torch.float64),
                      1e-5)


_CORRUPT_TABLE = """
import torch
from flexflow_tpu_torch.kernels import flash_attention as fa
dev = torch.device("cuda")
q = torch.randn(2, 1, 64, device=dev)
pool = torch.randn(3, 4, 64, device=dev)
table = torch.tensor([[1, 2], [2, 3]], dtype=torch.int32, device=dev)
lengths = torch.tensor([8, 8], dtype=torch.int32, device=dev)
fa.paged_flash_decode_attention(q, pool, pool, table, lengths, num_heads=1)
torch.cuda.synchronize()
print("NO ERROR")
"""


@pytest.mark.cuda
def test_paged_kernel_stops_on_a_page_table_entry_outside_the_pool(cuda):
    """Block 3 of a 3-block pool: the kernel stops with a device assert
    (in a child process, whose CUDA context it ends), as the plain
    version's gather raises, rather than read another slot's block."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _CORRUPT_TABLE], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "NO ERROR" not in proc.stdout, (
        proc.stdout, proc.stderr)
    assert "assert" in proc.stderr.lower(), proc.stderr
