"""The port's ranks of ``tests/test_torch_sharded.py``: each rank of a
``launch/mesh.py::spawn`` group runs :func:`run_world`, every case of its
world on the gloo group, and returns what it computed (numpy and
Python values).  Imports torch and the port only."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

import _sharded_cases as cases


def _lm_step(lm, block: int):
    """The shardmap round step on this rank's slot of the smoke LM."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_slot_to_reference, lm_stack_from_reference
    from repro_torch.launch.steps import make_pigeon_round_step_shardmap
    model = lm_stack_from_reference(get_smoke_config(cases.LM["arch"]),
                                    [lm["trees"][dist.get_rank()]])
    step = make_pigeon_round_step_shardmap(model, None, cases.LR, block=block)
    batches = {k: torch.from_numpy(v if block > 1 else v[0])
               for k, v in lm["batches"].items()}
    vlosses, sel = step(batches, {k: torch.from_numpy(v) for k, v in lm["val"].items()})
    return dict(vlosses=vlosses.numpy(), sel=sel.numpy(),
                slot0=lm_slot_to_reference(model, 0))


class _Toy(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)


def _inf_slot(_):
    """A two-cluster launch round at world 2 whose losing cluster (rank
    1's) trains to Inf: the winner all rank 0's, finite on every rank."""
    from repro_torch.core.runner import RoundRunner, RoundSpec

    @torch.no_grad()
    def train(params, batches):                  # a batch row: (cluster, loss)
        params.w.copy_(torch.where((batches[:, 0] == 1)[:, None], float("inf"),
                                   params.w - 0.1))
        return params, batches[:, 1]

    def validate(params, val):
        return (params.w.detach() ** 2).mean(-1), None

    spec = RoundSpec(train, validate, train_summary=lambda aux: aux,
                     lead=lambda b: (b.shape[0],), take=lambda b, lanes, c: b[c])
    model = _Toy(torch.full((1, 3), float(dist.get_rank() + 1)))
    runner = RoundRunner(spec, placement="sharded", params_stacked=True)
    _, vlosses, sel = runner.round(model, torch.tensor([[0.0, 1.0], [1.0, 1.0]]), None)
    return dict(w=model.w.detach().numpy(), vlosses=vlosses.numpy(), sel=int(sel))


def _meshes(_):
    """This group's ``cluster_mesh`` and ``sweep_mesh`` shapes for every R,
    S up to 8 and max_devices up to the world."""
    from repro_torch.core.runner import cluster_mesh, sweep_mesh
    w = dist.get_world_size()
    return dict(meshes={(r, m): cluster_mesh(r, m).shape
                        for m in range(1, w + 1) for r in range(1, 9)},
                sweep_meshes={(s, r, m): sweep_mesh(s, r, m).shape
                              for m in range(1, w + 1) for r in range(1, 9)
                              for s in range(1, 9)})


SPECIAL = {"lm_step": lambda lm: _lm_step(lm, 1), "lm_step_block2": lambda lm: _lm_step(lm, 2),
           "inf_slot": _inf_slot, "meshes": _meshes}


def run_world(names, inits, lm, nice=0):
    """Every case of ``names`` on this rank, at niceness ``nice``: the
    drivers' rounds, the LM step's outputs, the Inf case, the meshes."""
    import os

    import repro_torch.core as tcore
    os.nice(nice)
    from repro_torch.convert import from_reference
    from repro_torch.data import build_image_task
    data, cfg = build_image_task("mnist", **cases.TASK)
    thetas = {s: from_reference(cfg, *inits[s]) for s in inits}
    module = dataclasses.replace(tcore.from_cnn(cfg), init=lambda g: thetas[g.initial_seed()])
    out = {}
    for name in names:
        if name in cases.CASES:
            out[name] = cases.run_case(tcore, module, data, name, device="cpu")
        else:
            out[name] = SPECIAL[name](lm)
    return out


def hang():
    """Rank 0 waits in a collective rank 1 never joins."""
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))
    else:
        import time
        time.sleep(3600)
    return np.zeros(1)
