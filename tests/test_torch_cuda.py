"""The CUDA delta-chunk kernel on the card, against its plain version.

Every test here needs an NVIDIA GPU and `nvcc` (the kernel builds at
first use) and skips without a card.  The file imports no JAX, so it
runs on a machine that has none, from the root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Anchors come from the port's own f64 setup of numpy-seeded smoke LPs,
advanced by absolute f64 ADMM steps (`chip_smoke.mid_solve_state`).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from abip_tpu_torch.ops import admm_delta as delta  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_rand,B", [(50, 1950, 4), (37, 374, 3)])
def test_kernel_matches_plain_on_card(cuda_device, m, n_rand, B):
    """T=64, thresh=0: equal t_done, and every output within the
    tolerance `chip_smoke.compare` states (rtol 2e-5 plus 1e-5 of the
    output's largest magnitude: both versions reduce in f32, in other
    orders)."""
    _, stacks = chip_smoke.smoke_batch(700, B, m=m, n_rand=n_rand)
    S, u, v = chip_smoke.mid_solve_state(torch, stacks, cuda_device)
    anc = chip_smoke.make_anchor(torch, S, u, v, 0.0)
    t_max = torch.full((B,), 64, dtype=torch.int32, device=cuda_device)
    ker = delta.delta_chunk_cuda(anc, t_max, 8)
    plain = delta._delta_compute(anc, t_max, 8)
    torch.cuda.synchronize()
    assert ker[6][:, 5].tolist() == plain[6][:, 5].tolist() == [64.0] * B
    chip_smoke.compare(ker, plain, f"m={m} n={m + n_rand}")


@pytest.mark.cuda
def test_kernel_refuses_shape_beyond_shared_memory(cuda_device):
    """n=60,000 needs more shared memory per block than the card has:
    the wrapper raises instead of launching."""
    B, m, n = 1, 1, 60_000
    z = {name: torch.zeros((B, m if name in delta._M_FIELDS else n),
                           dtype=torch.float32, device=cuda_device)
         for name in delta.DeltaAnchor._fields}
    z["scal"] = torch.zeros((B, delta.N_SCAL), device=cuda_device)
    z["A"] = torch.zeros((B, m, n), device=cuda_device)
    z["Ninv"] = torch.zeros((B, m, m), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        delta.delta_chunk_cuda(delta.DeltaAnchor(**z),
                               torch.ones((B,), dtype=torch.int32), 8)


@pytest.mark.cuda
def test_solve_on_card_goes_through_kernel(cuda_device):
    """A batch solved on CUDA tensors runs its chunks in the kernel, and
    each lane's objective agrees with scipy's HiGHS to 1e-5 relative."""
    from scipy.optimize import linprog

    from abip_tpu_torch.parallel.batched import solve_lp_batch

    data, stacks = chip_smoke.smoke_batch(800, 3, m=20, n_rand=180)
    delta.delta_chunk_cuda.launches = 0
    res = solve_lp_batch(*stacks, device=cuda_device,
                         **dict(chip_smoke.SOLVE_KW, qres_period=256))
    assert delta.delta_chunk_cuda.launches > 0
    assert res.status.tolist() == [1, 1, 1]
    for (A, b, c), pobj in zip(data, res.pobj.cpu().numpy()):
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
        assert abs(pobj - ref.fun) < 1e-5 * (1 + abs(ref.fun))
