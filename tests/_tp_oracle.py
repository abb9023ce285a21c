"""The reference's tensor-parallel runs for
``tests/test_torch_tensor_parallel.py`` over an 8-device host mesh, in a
process of its own: run as

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/_tp_oracle.py INPUTS.pkl OUT.pkl

``INPUTS.pkl`` maps each case of :data:`CASES` to its parameters and inputs
(numpy).  Each runs under ``jax.jit`` over a (2, 4) ``("data", "model")``
mesh of host devices with the reference's own ``param_shardings``,
``batch_shardings`` and ``cache_shardings(seq_shard=...)`` as
``in_shardings``: the serve loop of a decode case (its cache sharded on its
sequence where the KV heads do not split over ``model``), the loss, the
gradients and the train step of a train case.  Nothing in ``repro``
changes."""
import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

#: case -> (kind, smoke arch, config overrides, seq_shard): the dense_kv2
#: decode (8 positions a model rank at 2 KV heads over 4), the train step
#: of query heads model 4 does not divide (the reference splits inside a
#: head), the batch-1 decode under the reference's seq_shard layout, the
#: MLA serve loop (its latent's sequence over model), the Zamba2 and xLSTM
#: train steps (in_proj's and up's columns cut across their sections)
CASES = {"dense_kv2": ("serve", "qwen3-8b", {"n_kv_heads": 2}, False),
         "heads6": ("train", "qwen3-8b", {"n_heads": 6, "n_kv_heads": 2}, False),
         "decode1": ("serve", "qwen3-8b", {}, True),
         "mla": ("serve", "deepseek-v2-lite-16b", {}, False),
         "zamba2": ("train", "zamba2-1.2b", {"attn_every": 1}, False),
         "xlstm": ("train", "xlstm-1.3b", {}, False)}
MESH = ((2, 4), ("data", "model"))
LR = 0.1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _serve(jm, params, prompts, new, mesh, seq_shard):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch import shardings as shd
    from repro.launch import steps as jsteps
    b = prompts.shape[0]
    cache = jm.init_cache(b, prompts.shape[1] + new)
    p_sh = shd.param_shardings(params, mesh)
    c_sh = shd.cache_shardings(cache, mesh, b, seq_shard=seq_shard)
    rep = NamedSharding(mesh, P())
    step = jax.jit(jsteps.make_serve_step(jm), in_shardings=(p_sh, c_sh, rep, rep),
                   out_shardings=(rep, c_sh))
    params, cache = jax.device_put(params, p_sh), jax.device_put(cache, c_sh)
    logits = None
    for i in range(prompts.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, i:i + 1]),
                             jnp.asarray(i, jnp.int32))
    prompt_logits = np.asarray(logits)
    out = []
    for j in range(new):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, jnp.asarray(prompts.shape[1] + j, jnp.int32))
    specs = {shd._path_str(k): tuple(v.spec) for k, v in
             jax.tree_util.tree_leaves_with_path(c_sh)}
    return dict(tokens=np.concatenate(out, axis=1), prompt_logits=prompt_logits,
                cache_specs=specs)


def _train(jm, params, batch, mesh):
    from repro.launch import shardings as shd
    from repro.launch import steps as jsteps
    p_sh = shd.param_shardings(params, mesh)
    b_sh = shd.batch_shardings(batch, mesh)
    params, batch = jax.device_put(params, p_sh), jax.device_put(batch, b_sh)
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True),
                               in_shardings=(p_sh, b_sh))(params, batch)
    updated, step_loss = jax.jit(jsteps.make_train_step(jm, LR),
                                 in_shardings=(p_sh, b_sh))(params, batch)
    specs = {shd._path_str(k): tuple(v.spec) for k, v in
             jax.tree_util.tree_leaves_with_path(p_sh)}
    return dict(loss=float(loss), grads=_np(grads), step_loss=float(step_loss),
                updated=_np(updated), param_specs=specs)


def main(inputs_path: str, out_path: str) -> None:
    from jax.sharding import Mesh

    from repro.configs import get_smoke_config
    from repro.models import build_model
    assert jax.device_count() == 8, jax.devices()
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    dims, axes = MESH
    mesh = Mesh(np.array(jax.devices()).reshape(dims), axes)
    out = {}
    for case, (kind, arch, over, seq_shard) in CASES.items():
        jm = build_model(dataclasses.replace(get_smoke_config(arch), **over))
        inp = inputs[case]
        params = jax.tree.map(jnp.asarray, inp["params"])
        with mesh:
            if kind == "serve":
                out[case] = _serve(jm, params, inp["prompts"], inp["new"], mesh, seq_shard)
            else:
                out[case] = _train(jm, params, {k: jnp.asarray(v)
                                                for k, v in inp["batch"].items()}, mesh)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, out_path)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
