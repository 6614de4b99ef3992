"""Regenerate ``src/repro_torch/core/xla_pow.py``: the τ < 2^20 at which
XLA's CPU f32 power (1 + τ)^-0.5, as ``repro.core.aggregation`` computes
it, is not the correctly rounded f32 value, each with the direction of
its one-ulp step.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/gen_xla_pow_table.py

The script checks that its base (1 / sqrt(1 + τ) in f64, rounded once to
f32) is the correctly rounded value at every τ, exactly in integers, and
that XLA is never more than one ulp from it. The list does not depend on
α₀: α(τ) = f32(α₀) · power is one f32 multiply on both sides.
"""
import pathlib

import numpy as np

import jax.numpy as jnp

MAX_TAU = 1 << 20
OUT = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
       / "core" / "xla_pow.py")


def correctly_rounded(x: int, y: np.float32) -> bool:
    """Is f32 ``y`` the nearest f32 to x^-0.5? Exact: y lies between the
    midpoints to its neighbours, m_lo <= x^-0.5 <= m_hi, that is
    m_lo^2 · x <= 1 <= m_hi^2 · x, in integers scaled by 2^(2e)."""
    lo = np.nextafter(y, np.float32(0))
    hi = np.nextafter(y, np.float32(np.inf))
    m, e = np.frexp(np.float64(y))           # y = m · 2^e, 0.5 <= m < 1
    s = 64 - int(e)                          # y · 2^s is an integer
    yi = int(np.float64(y) * 2.0 ** s)
    lo_i = int(np.float64(lo) * 2.0 ** s)
    hi_i = int(np.float64(hi) * 2.0 ** s)
    m_lo2, m_hi2 = lo_i + yi, hi_i + yi      # 2 · midpoint · 2^s
    one = 4 << (2 * s)                       # (2 · 2^s)^2
    return m_lo2 * m_lo2 * x <= one <= m_hi2 * m_hi2 * x


def main() -> None:
    tau = np.arange(MAX_TAU)
    xla = np.asarray((1.0 + jnp.asarray(tau, jnp.float32))
                     ** jnp.float32(-0.5))
    base = (1.0 / np.sqrt(1.0 + tau.astype(np.float64))).astype(np.float32)
    bad = [t for t in range(MAX_TAU)
           if not correctly_rounded(t + 1, base[t])]
    if bad:
        raise SystemExit(f"base not correctly rounded at τ = {bad[:10]}")
    step = (xla.view(np.int32).astype(np.int64)
            - base.view(np.int32).astype(np.int64))
    if np.abs(step).max() > 1:
        raise SystemExit("XLA's power is more than one ulp off")
    up = np.nonzero(step == 1)[0].tolist()
    down = np.nonzero(step == -1)[0].tolist()

    def block(name, values):
        rows = [", ".join(str(v) for v in values[i:i + 10])
                for i in range(0, len(values), 10)]
        return (f"{name} = (\n" + "".join(f"    {r},\n" for r in rows)
                + ")\n")

    OUT.write_text(
        '"""The τ < MAX_TAU at which XLA\'s CPU f32 power (1 + τ)^-0.5 is\n'
        "one ulp above (UP) or below (DOWN) the correctly rounded f32 value.\n"
        "\n"
        "Generated by tests/gen_xla_pow_table.py from the JAX package; do\n"
        'not edit by hand."""\n\n'
        f"MAX_TAU = 1 << 20\n\n" + block("UP", up) + "\n"
        + block("DOWN", down))
    print(f"wrote {OUT}: {len(up)} up, {len(down)} down")


if __name__ == "__main__":
    main()
