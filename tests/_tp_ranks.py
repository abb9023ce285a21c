"""The port's ranks of ``tests/test_torch_tensor_parallel.py``: each rank
of a ``launch/mesh.py::spawn`` gloo group runs :func:`run_world`, every
case of its world over each of its meshes, and returns what it computed
(numpy and Python values).  Imports torch and the port only."""
import dataclasses

import numpy as np
import torch

#: the smoke configs' cases: (config overrides, optimizations).
#: "dense_kv2" has fewer KV heads than model 4 (a KV head on 2 ranks, its
#: cache's sequence split between them), "heads6" query heads model 4 does
#: not divide (the attention block whole on each rank, its cache split
#: over the model axis), "vocab513" a vocab it does not divide (the
#: embedding and the head whole), "dense_kv1" one KV head (a batch-1
#: cache over (2, 2): the panels span data and model).  The last layer
#: kinds: "mla" DeepSeek-V2-Lite's (4 heads, rank 64, 4 experts: its
#: latent cache split on its sequence over every model rank), "zamba2"
#: (8 SSD heads, d_state 16; attn_every 1 puts the shared block between
#: its two Mamba2 layers), "xlstm" (4 heads: an mLSTM split by heads, an
#: sLSTM whole), "xlstm_heads2" (2 heads at model 4: both mixers whole),
#: "seamless" (the encoder and the cross-attending decoder)
ARCHS = {"dense": ("qwen3-8b", {}, ()),
         "dense_kv2": ("qwen3-8b", {"n_kv_heads": 2}, ()),
         "dense_kv1": ("qwen3-8b", {"n_kv_heads": 1}, ()),
         "heads6": ("qwen3-8b", {"n_heads": 6, "n_kv_heads": 2}, ()),
         "vocab513": ("qwen3-8b", {"vocab": 513}, ()),
         "moe": ("qwen3-moe-30b-a3b", {}, ("moe_shard",)),
         "mla": ("deepseek-v2-lite-16b", {}, ()),
         "zamba2": ("zamba2-1.2b", {"attn_every": 1}, ()),
         "xlstm": ("xlstm-1.3b", {}, ()),
         "xlstm_heads2": ("xlstm-1.3b", {"n_heads": 2}, ()),
         "seamless": ("seamless-m4t-medium", {}, ())}
#: the last layer kinds' archs, at (1, 2), (1, 4) and (2, 2)
FAMILIES = ("mla", "zamba2", "xlstm", "seamless")
#: the round step over (pod, data, model): the dense stack and the
#: stacked forms of the last layer kinds (the encoder-decoder has no
#: Pigeon-SL protocol round)
ROUND_CASES = ("dense", "mla", "zamba2", "xlstm")
#: an encoder-decoder's frames a batch row (its memory's length)
FRAMES = 12
#: world -> [(case, mesh dims over ("data", "model"))]; "round" runs over
#: ("pod", "data", "model"); a "decode1" case is a batch-1 serve loop (the
#: cache's sequence over the data ranks too)
WORLDS = {2: [("dense", (1, 2)), ("moe", (1, 2))] + [(f, (1, 2)) for f in FAMILIES],
          4: [("dense", (1, 4)), ("dense", (2, 2)), ("dense_kv2", (1, 4)),
              ("heads6", (1, 4)), ("vocab513", (1, 4)), ("vocab513", (2, 2)),
              ("moe", (1, 4)), ("moe", (2, 2)),
              ("decode1", "dense", (4, 1)), ("decode1", "dense_kv1", (2, 2)),
              ("decode1", "mla", (2, 2)), ("xlstm_heads2", (1, 4))]
             + [(f, dims) for f in FAMILIES for dims in ((1, 4), (2, 2))]
             + [("round", f, (2, 1, 2)) for f in ROUND_CASES]}
#: the case whose planted fault skips out_norm's sum-of-squares all-reduce
NORM_FAULT = ("zamba2", (1, 2))
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
    from repro_torch.models.parallel import all_reduce_grads, collective, layout
    cfg = config(case)
    mesh = make_mesh(dims, ("data", "model"))
    model = lm_from_reference(cfg, inputs["params"], mesh)
    par = model.par
    batch = {k: torch.from_numpy(v).long() if k != "frames" else torch.from_numpy(v)
             for k, v in inputs["batch"].items()}
    loss, _ = model.loss(par.batch_rows(batch))
    grads = all_reduce_grads(torch.autograd.grad(loss, list(model.parameters())), par)
    gmodel = lm_from_reference(cfg, inputs["params"], mesh)
    with torch.no_grad():
        for p, g in zip(gmodel.parameters(), grads):
            p.copy_(g)
    out = dict(loss=float(loss.detach()), grads=lm_to_reference(gmodel))
    if case == "heads6":
        # a planted fault: the whole attention block's gradients summed over
        # model, as if each rank held a shard (the comparison must fail)
        with torch.no_grad():
            for name, p in gmodel.named_parameters():
                if ".attn." in name and layout(p) is None:
                    collective("all_reduce", p.data, par.model_group)
        out["planted_grads"] = lm_to_reference(gmodel)
    if (case, dims) == NORM_FAULT:
        out.update(_norm_fault(cfg, inputs, mesh, batch))
    with torch.no_grad():
        out["prefill"] = steps.make_prefill_step(model)(batch).numpy()
    out["step_loss"] = float(steps.make_train_step(model, LR)(batch))
    out["updated"] = lm_to_reference(model)
    model = lm_from_reference(cfg, inputs["params"], mesh)
    prompts = torch.from_numpy(inputs["batch"]["tokens"][:, :PROMPT]).long()
    cache = model.init_cache(B, PROMPT + NEW)
    memory = None if "memory" not in inputs else torch.from_numpy(inputs["memory"])
    tokens, logits = serve.greedy_decode(steps.make_serve_step(model), cache, prompts, NEW,
                                         memory)
    out["tokens"], out["prompt_logits"] = tokens.numpy(), logits.numpy()
    out["cache_shapes"] = {f"{i}/{k}": tuple(t.shape) for i, c in enumerate(cache)
                           for k, t in c.items()}
    out["panels"] = cache.panels.count
    return out


def _norm_fault(cfg, inputs, mesh, batch):
    """A planted fault: ``out_norm``'s sum of squares left unreduced over
    ``model`` (each rank normalising by its own heads' mean): the
    gradients and the prefill logits, which the comparisons must fail."""
    from repro_torch.convert import lm_from_reference, lm_to_reference
    from repro_torch.launch import steps
    from repro_torch.models import parallel
    from repro_torch.models.parallel import all_reduce_grads
    saved = parallel.sum_over
    parallel.sum_over = lambda x, par: x
    try:
        model = lm_from_reference(cfg, inputs["params"], mesh)
        loss, _ = model.loss(model.par.batch_rows(batch))
        grads = all_reduce_grads(torch.autograd.grad(loss, list(model.parameters())),
                                 model.par)
        with torch.no_grad():
            prefill = steps.make_prefill_step(model)(batch).numpy()
            for p, g in zip(model.parameters(), grads):
                p.copy_(g)
    finally:
        parallel.sum_over = saved
    return dict(planted_norm_grads=lm_to_reference(model), planted_norm_prefill=prefill)


def _decode1(case: str, dims, inputs):
    """The batch-1 serve loop (``inputs["prompt"]`` (1, PROMPT), NEW greedy
    tokens) of this rank's part of the model: the cache's panels span the
    data ranks (every rank holds the row) and the model ranks that share a
    KV head."""
    from repro_torch.convert import lm_from_reference
    from repro_torch.launch import serve, steps
    from repro_torch.launch.mesh import make_mesh
    cfg = config(case)
    model = lm_from_reference(cfg, inputs["params"], make_mesh(dims, ("data", "model")))
    cache = model.init_cache(1, PROMPT + NEW)
    tokens, logits = serve.greedy_decode(steps.make_serve_step(model), cache,
                                         torch.from_numpy(inputs["prompt"]).long(), NEW)
    return dict(tokens=tokens.numpy(), prompt_logits=logits.numpy(), panels=cache.panels.count,
                rows_whole=cache.panels.rows_whole,
                cache_shape=tuple(next(iter(cache[0].values())).shape))


def _round(case, dims, inputs):
    """The round step over (pod, data, model): a slot a pod, the parallel
    model within it."""
    import torch.distributed as dist

    from repro_torch.convert import lm_slot_to_reference, lm_stack_from_reference
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_pigeon_round_step_shardmap
    cfg = config(case)
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
    for case, *rest in WORLDS[world]:
        if case == "round":
            name, dims = rest
            out[(case, name, dims)] = _round(name, dims, inputs[("round", name)])
        elif case == "decode1":
            name, dims = rest
            out[(case, name, dims)] = _decode1(name, dims, inputs[("decode1", name)])
        else:
            out[(case, rest[0])] = _lm_case(case, rest[0], inputs[case])
    return out
