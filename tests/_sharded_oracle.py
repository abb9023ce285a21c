"""The reference's ``placement="sharded"`` runs for
``tests/test_torch_sharded.py``, in a process of its own: run as

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python tests/_sharded_oracle.py INPUTS.pkl OUT.pkl

``INPUTS.pkl`` holds the LM step's parameters and batches (numpy); the
result holds every case of ``_sharded_cases.CASES`` run through
``repro.core`` over an 8-device host mesh, the shardmap step's outputs, and
the reference's ``cluster_mesh`` / ``sweep_mesh`` shapes for 1 to 8
devices.  Nothing in ``repro`` changes."""
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _sharded_cases as cases  # noqa: E402


def main(inputs_path: str, out_path: str) -> None:
    import repro.core as jcore
    from repro.configs import get_smoke_config
    from repro.core.runner import cluster_mesh, sweep_mesh
    from repro.data import build_image_task
    from repro.launch import steps as jsteps
    from repro.models import build_model

    assert jax.device_count() == 8, jax.devices()
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    out = {"meshes": {}, "sweep_meshes": {}, "runs": {}, "lm": {}}
    for m in range(1, 9):
        for r in range(1, 9):
            out["meshes"][(r, m)] = dict(cluster_mesh(r, m).shape)
            for s in range(1, 9):
                out["sweep_meshes"][(s, r, m)] = dict(sweep_mesh(s, r, m).shape)

    data, cfg = build_image_task("mnist", **cases.TASK)
    module = jcore.from_cnn(cfg)
    for name in cases.CASES:
        if name not in cases.BIT_EQUAL:
            out["runs"][name] = cases.run_case(jcore, module, data, name,
                                               **cases.REFERENCE_KW.get(name, {}))

    jm = build_model(get_smoke_config(cases.LM["arch"]))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *inputs["lm_trees"])
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:cases.LM["r"]]).reshape(-1, 1, 1),
                ("pod", "data", "model"))
    val = {k: jnp.asarray(v) for k, v in inputs["lm_val"].items()}
    for block in (1, 2):
        step = jax.jit(jsteps.make_pigeon_round_step_shardmap(jm, mesh, cases.LR, block=block))
        batches = {k: jnp.asarray(v if block > 1 else v[0])
                   for k, v in inputs["lm_batches"].items()}
        res = step(stacked, batches, val)
        rebro, (vl, sel) = (res[0], res[1]) if block > 1 else (res[0], res[1:])
        out["lm"][block] = dict(vlosses=np.asarray(vl), sel=np.asarray(sel),
                                slot0=jax.tree.map(lambda x: np.asarray(x[0]), rebro))
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, out_path)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
