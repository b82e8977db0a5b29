"""The port's legacy online loop (``OnlineExecutor(fused=False)``: the
estimator's ``observe_batch`` + dirty-row ``predict_matrix``) held to the
JAX package's legacy loop on the CPU, on the five paper workflows with
faults off and on.  The scenario and the bar are those of
``tests/test_torch_online.py``; this file stands apart so that the JAX
legacy runs (seconds each) run beside the rest of the suite.
"""
import pytest

from repro.sched.workflows import WORKFLOWS
from test_torch_online import _run, _traces_agree, _x64, cluster  # noqa: F401


@pytest.mark.parametrize("wf", list(WORKFLOWS))
@pytest.mark.parametrize("with_faults", [False, True],
                         ids=["faults_off", "faults_on"])
def test_legacy_executor_matches_jax(cluster, wf, with_faults):  # noqa: F811
    ref = _run(cluster, wf, port=False, fused=False,
               with_faults=with_faults)
    got = _run(cluster, wf, port=True, fused=False, with_faults=with_faults)
    _traces_agree(got, ref)
