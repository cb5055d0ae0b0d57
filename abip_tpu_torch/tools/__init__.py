"""Validators of the port and the instance generators they draw from.

`generate` holds the random instances with known answers (conic programs
built around a complementary pair, infeasible and unbounded LPs);
`fuzz_conic` and `fuzz_scipy` solve them under exact contracts:

    python -m abip_tpu_torch.tools.fuzz_conic --batched --engine sprint2
    python -m abip_tpu_torch.tools.fuzz_scipy --per-class 5

Both run on the CUDA card unless given `--cpu`.
"""
