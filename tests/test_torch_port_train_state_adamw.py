"""PyTorch port: the detector's AdamW training-state `.ckpt` files against
the JAX trainer's (`optimizer="adamw"`, always the tree form), f32 on the
CPU, yolov12n-seg (4 ch, nc=1) at 64^2 and batch 2.

The checks of `test_torch_port_train_state.py` for the AdamW layout: each
group's `(ScaleByAdamState{count, mu, nu}, {}, ScaleByScheduleState{count})`
with `{}` outside the group, torch AdamW's `step`, `exp_avg` and
`exp_avg_sq` as optax's `count`, `mu` and `nu`. Both directions after the
same three steps from one init, the next step from each side's restored
state, and the JAX file written back byte for byte (AdamW's state has no
hyperparams scalars: every byte). Tolerances as there: the parameters, EMA
and statistics 1e-4 absolute; the moments every element within 1e-3 and
all but 0.1 % within 1e-4 (`mu` is b1's running mean of gradients, `nu` of
their squares). AdamW moves every element by about lr an update whatever
the size of its gradient, so an element whose gradient is f32 noise moves
by up to lr in either direction on either side (the decoder trainer's
test notes the same): at the trajectory file's rates (lr0 2e-3, the bias
warmup from 2e-2) the losses part by 1e-3 after one update. The rates here
are LR = 1e-5 for both groups, so that three such moves stay inside 1e-4.
"""

import pytest

from .test_torch_port_train_state import (check_jax_steps_from_port_file,
                                          check_port_file_in_jax,
                                          check_port_next_step,
                                          check_port_restores_jax_file,
                                          check_round_trip, make_runs,
                                          variables)  # noqa: F401
from .torch_threads import one_torch_thread  # noqa: F401

LR = 1e-5


@pytest.fixture(scope="module")
def runs(variables, tmp_path_factory):  # noqa: F811
    return make_runs(variables, tmp_path_factory.mktemp("adamw_state"),
                     optimizer="adamw", lr0=LR, warmup_bias_lr=LR)


def test_port_file_restores_in_jax_near_its_state(runs):
    check_port_file_in_jax(runs)


def test_jax_steps_on_from_the_port_file(runs):
    check_jax_steps_from_port_file(runs)


def test_port_restores_the_jax_file_bit_for_bit(runs, variables):  # noqa: F811
    tr = check_port_restores_jax_file(runs, variables)
    steps = {float(tr.optimizer.state[p]["step"]) for p in tr.params}
    assert steps == {3.0}
    assert all({"exp_avg", "exp_avg_sq"} <= set(tr.optimizer.state[p])
               for p in tr.params)


def test_port_next_step_from_the_jax_file_agrees(runs, variables):  # noqa: F811
    check_port_next_step(runs, variables)


def test_jax_file_round_trips_through_the_port_byte_for_byte(
        runs, variables):  # noqa: F811
    assert check_round_trip(runs, variables)
