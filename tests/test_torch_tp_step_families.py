"""The other generator families under tensor parallelism: one fp32 step on
``dp = 1 x tp = 2`` (gloo ranks, ``tests/torch_dp_workers.py``'s
``job_tp_step``, ``tp_min_size = 1 << 12``) of ``concept_in_df_gan.yml``
with each word-attention generator (CONCEPT_INATTN_GEN,
CONCEPT_OUTATTN_GEN: their GroupedDense projections split inside each
group, the BatchNorm over the global batch, ``cross_attention`` on the
gathered queries) and as published (CONCEPT_IN_DF_GEN), against the port's
one-process step with ``tests/torch_dp_step_parity.py``'s tolerances
(metrics to 1e-5 relative; every element within 2 lr, 99.9% within 1e-5),
the replicated leaves bit-equal and the split weights ``1/tp`` of their rows
(``tests/test_torch_tp_step.py``'s checks).  The DF and concept-DF families
are held to JAX and to one process there."""

import pytest

from test_torch_tp_step import _check_layout
from torch_dp_step_parity import check_dp_vs_one_process, run_tp_step
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)

MESH = (1, 2)


@pytest.mark.parametrize("name", ["word_attention", "word_attention_out", "concept_in_df"])
def test_tp_family_step_matches_the_one_process_step(one_torch_thread, name, tmp_path):
    run = run_tp_step(name, tmp_path, (MESH,), 1 << 12, with_jax=False)["meshes"][MESH]
    check_dp_vs_one_process(run)
    _check_layout(run, MESH[1])
