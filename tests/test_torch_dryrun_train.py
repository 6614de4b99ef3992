"""The training step of every full-size architecture traced on meta by the
port's dry run (``repro_torch.launch.dryrun.trace_step``: ``make_raw_step``
on the 1 × 1 mesh's one client) against ``jax.eval_shape`` of the JAX
package's step: the new state's parameters, optimizer state, reference
signs, step and running metrics, and the step's metrics, of the same
shapes and dtypes, and the state's structure kept round the step (the
counterpart of ``tests/test_abstract_lowering.py``'s training combos).

Shapes and dtypes must be equal. The port's metrics add ``ratios`` (the θ
ratios, which the JAX package does not return); the rest are JAX's keys.
"""
import jax
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core import fl_step as jfl
from repro.models import api as japi
from repro.optim import adamw as jopt

from repro_torch.launch import dryrun

from test_torch_dryrun import jax_leaves, torch_leaves

ARCHS = list(jreg.ASSIGNED_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_train_step_matches_eval_shape(arch):
    jc = jreg.config_for_shape(arch, "train_4k")
    opt = jopt.for_config(jc)
    specs = japi.input_specs(jc, JSHAPES["train_4k"], num_clients=1)
    state = jax.eval_shape(lambda: jfl.init_state(jax.random.PRNGKey(0), jc,
                                                  opt))
    want_state, want_metrics = jax.eval_shape(
        jfl.make_raw_step(jc, opt, theta=0.65), state, specs["batch"])
    (got_state, got_metrics), census, _ = dryrun.trace_step(arch,
                                                            "train_4k")
    for field in ("params", "opt_state", "ref_sign", "step", "metrics"):
        got = torch_leaves({field: getattr(got_state, field)})
        assert got == jax_leaves({field: getattr(want_state, field)}), field
        assert got == jax_leaves({field: getattr(state, field)}), field
    assert set(got_metrics) == set(want_metrics) | {"ratios"}
    assert torch_leaves({k: got_metrics[k] for k in want_metrics}) == \
        jax_leaves(want_metrics)
    launches = census.analyze()["kernel_launches"]
    assert launches["per_client_sign_align"] == launches["masked_agg"] == 1
