"""The sharded placement's rounds (``placement="sharded"``: the cluster
axis over the ranks of a gloo group) of the xLSTM, Zamba2 (Mamba2 and the
shared attention block) and DeepSeek (MLA and the MoE) families, against
the vmap placement's on the CPU.

Each family's tiny model (``tests/_family_rounds.py``: the configs of
``tests/test_torch_xlstm_round.py``, ``tests/test_torch_hybrid.py`` and
``tests/test_torch_moe_round.py``) runs two rounds of ``run_pigeon`` on the
batched engine with a label-flipping client: once at ``placement="vmap"``
in this process, once over a group of 2 gloo ranks (one cluster a rank,
one intra-op thread a rank, at niceness ``NICE``).  Every rank's rounds
equal rank 0's exactly; rank 0's equal the vmap run's: the discrete
outcomes and ``comm`` exactly, the losses and test accuracy within rtol
1e-4 (``tests/test_torch_sharded.py``'s bound against the reference's
sharded runs)."""
import numpy as np
import pytest

import _family_rounds as fam
from _torch_threads import one_thread  # noqa: F401

DEADLINE_S = 240.0
NICE = 10
RTOL = 1e-4
DISCRETE = ("round", "clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")
FLOATS = ("val_losses", "train_losses", "test_acc")


@pytest.fixture(scope="module")
def sharded_runs():
    from repro_torch.launch.mesh import spawn
    return spawn(fam.run_sharded, 2, "gloo", DEADLINE_S, args=(tuple(fam.FAMILIES), NICE),
                 threads=1)


@pytest.mark.parametrize("family", sorted(fam.FAMILIES))
def test_sharded_rounds_equal_on_every_rank_and_the_vmap_rounds(sharded_runs, family):
    want = fam.run(family, "vmap")
    first = sharded_runs[0][family]
    for rank, res in enumerate(sharded_runs):
        assert res[family] == first, f"{family}: rank {rank}'s rounds differ from rank 0's"
    assert len(first) == len(want) == fam.PCFG["T"]
    for got, ref in zip(first, want):
        for key in DISCRETE:
            if key in ref:
                assert got[key] == ref[key], (family, ref["round"], key)
        for key in FLOATS:
            if key in ref:
                np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                           np.asarray(ref[key], np.float64), rtol=RTOL,
                                           err_msg=f"{family} round {ref['round']} {key}")
