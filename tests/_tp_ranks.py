"""The port's ranks of ``tests/test_torch_tensor_parallel.py``: each rank
of a ``launch/mesh.py::spawn`` gloo group runs :func:`run_world`, every
case of its world over each of its meshes, and returns what it computed
(numpy and Python values).  Imports torch and the port only."""
import dataclasses

import numpy as np
import torch

#: the smoke configs' cases: (config overrides, optimizations)
ARCHS = {"dense": ("qwen3-8b", {}, ()),
         "dense_kv2": ("qwen3-8b", {"n_kv_heads": 2}, ()),
         "moe": ("qwen3-moe-30b-a3b", {}, ("moe_shard",))}
#: world -> [(case, mesh dims over ("data", "model"))]; "round" runs over
#: ("pod", "data", "model")
WORLDS = {2: [("dense", (1, 2)), ("moe", (1, 2))],
          4: [("dense", (1, 4)), ("dense", (2, 2)), ("dense_kv2", (1, 4)),
              ("moe", (1, 4)), ("moe", (2, 2)), ("round", (2, 1, 2))]}
LR = 0.1
B, S, PROMPT, NEW = 4, 16, 8, 8


def config(case: str):
    from repro_torch.configs import get_smoke_config
    arch, over, opts = ARCHS[case]
    return dataclasses.replace(get_smoke_config(arch), optimizations=opts, **over)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_np(v) for v in tree)
    return np.asarray(tree)


def _lm_case(case: str, dims, inputs):
    """Loss, gradients, the updated parameters (each whole, gathered),
    prefill logits and the serve loop of this rank's part of the model."""
    from repro_torch.convert import lm_from_reference, lm_to_reference
    from repro_torch.launch import serve, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import all_reduce_grads
    cfg = config(case)
    mesh = make_mesh(dims, ("data", "model"))
    model = lm_from_reference(cfg, inputs["params"], mesh)
    par = model.par
    batch = {k: torch.from_numpy(v).long() for k, v in inputs["batch"].items()}
    loss, _ = model.loss(par.batch_rows(batch))
    grads = all_reduce_grads(torch.autograd.grad(loss, list(model.parameters())), par)
    gmodel = lm_from_reference(cfg, inputs["params"], mesh)
    with torch.no_grad():
        for p, g in zip(gmodel.parameters(), grads):
            p.copy_(g)
    out = dict(loss=float(loss.detach()), grads=lm_to_reference(gmodel))
    with torch.no_grad():
        out["prefill"] = steps.make_prefill_step(model)(batch).numpy()
    out["step_loss"] = float(steps.make_train_step(model, LR)(batch))
    out["updated"] = lm_to_reference(model)
    model = lm_from_reference(cfg, inputs["params"], mesh)
    prompts = torch.from_numpy(inputs["batch"]["tokens"][:, :PROMPT]).long()
    try:
        cache = model.init_cache(B, PROMPT + NEW)
    except NotImplementedError as e:
        out["decode_refused"] = str(e)
        return out
    tokens, logits = serve.greedy_decode(steps.make_serve_step(model), cache, prompts, NEW)
    out["tokens"], out["prompt_logits"] = tokens.numpy(), logits.numpy()
    out["cache_heads"] = int(cache[0]["k"].shape[-2])
    return out


def _round(dims, inputs):
    """The round step over (pod, data, model): a slot a pod, the parallel
    model within it."""
    import torch.distributed as dist

    from repro_torch.convert import lm_slot_to_reference, lm_stack_from_reference
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_pigeon_round_step_shardmap
    cfg = config("dense")
    mesh = make_mesh(dims, ("pod", "data", "model"))
    pod = mesh.coord("pod")
    model = lm_stack_from_reference(cfg, [inputs["trees"][pod]], mesh)
    step = make_pigeon_round_step_shardmap(model, mesh, LR)
    vlosses, sel = step({k: torch.from_numpy(v) for k, v in inputs["batches"].items()},
                        {k: torch.from_numpy(v) for k, v in inputs["val"].items()})
    return dict(vlosses=vlosses.numpy(), sel=sel.numpy(), rank=dist.get_rank(),
                slot0=lm_slot_to_reference(model, 0))


def run_world(world: int, inputs, nice: int = 0):
    """Every case of ``world`` on this rank, at niceness ``nice``."""
    import os
    os.nice(nice)
    out = {}
    for case, dims in WORLDS[world]:
        if case == "round":
            out[(case, dims)] = _round(dims, inputs["round"])
        else:
            out[(case, dims)] = _lm_case(case, dims, inputs[case])
    return out
