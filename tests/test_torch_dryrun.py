"""The port's roofline, op counter, meta rule and dry run
(``repro_torch.launch.{roofline,op_analysis,dryrun}``, ``kernels/ops.py``'s
meta rule): the roofline terms on the H100's constants (the reference's
``tests/test_launch.py::test_roofline_terms_math`` mirrored), the meta
model's parameters at full size against the reference's
``jax.eval_shape(model.init)``, the dry run of every smoke configuration's
prefill and train steps on the meta device, the dense smoke train step's
product FLOPs outside the kernels against the reference's ``analyze_hlo``
of the same step lowered on the CPU (within 1%, the gap named product by
product), and the kernel-work formulas against the bounds PERF.md's kernel
table states."""
import math

import numpy as np
import pytest
import torch
from _torch_threads import one_thread  # noqa: F401

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.launch.shapes import SHAPES, InputShape
from repro_torch.launch.steps import input_specs

META = torch.device("meta")


def test_roofline_terms_math():
    rl = roofline.roofline_terms(989e12, 3.35e12, 0, chips=1, kind="train",
                                 active_params=1_000_000, tokens=1000)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == 0.0
    assert rl.model_flops == 6e9
    rl2 = roofline.roofline_terms(1, 3.35e12 * 2, 0, 1, "prefill", 10, 10)
    assert rl2.dominant == "memory"
    assert rl2.model_flops == 2 * 10 * 10
    assert set(rl.as_dict()) == {"compute_s", "memory_s", "collective_s", "dominant",
                                 "model_flops", "hlo_flops_global", "useful_ratio"}
    assert roofline.mfu(989e12, 2.0) == pytest.approx(0.5)
    # the collective term across cards: NVLink within a node of 8, the
    # network where the mesh spans nodes (once refused as multi-card)
    rl4 = roofline.roofline_terms(1, 1, 450e9, 4, "train", 1, 1)
    assert rl4.collective_s == pytest.approx(1.0) and rl4.dominant == "collective"
    rl256 = roofline.roofline_terms(1, 1, 50e9, 256, "train", 1, 1)
    assert rl256.collective_s == pytest.approx(1.0)
    assert roofline.link_rate(8) == roofline.NVLINK_BYTES_PER_S
    assert roofline.link_rate(16) == roofline.NETWORK_BYTES_PER_S


@pytest.mark.parametrize("arch", list_archs())
def test_meta_model_params_match_reference(arch):
    """At full size: the port's model on the meta device holds the
    reference's parameters, element for element in count."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build
    from repro_torch.models.model import Model, build_plan
    shapes = jax.eval_shape(ref_build(ref_config(arch)).init, jax.random.PRNGKey(0))
    want = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    cfg = get_config(arch)
    model = Model(cfg, build_plan(cfg), META)
    assert sum(p.numel() for p in model.parameters()) == want
    assert all(p.device == META for p in model.parameters())


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_smoke_steps_dry_run_on_meta(arch, shape):
    cfg = get_smoke_config(arch)
    spec = input_specs(cfg, shape)
    s = SHAPES[shape]
    rec = dryrun.analyze(spec, spec.args, s.kind, dryrun.step_tokens(s),
                         cfg.active_param_count())
    ops_ = rec["ops"]
    assert ops_["host_transfers"] == {}
    assert ops_["flops"] > 0 and ops_["product_flops"] > 0 and ops_["bytes"] > 0
    # the attention families run B5 (MLA's latent attention and the smoke
    # Zamba2's two Mamba2 layers run none); the smoke xLSTM's sLSTM block B7
    want = ({"slstm_scan"} if cfg.arch_type == "ssm" else
            set() if cfg.arch_type == "hybrid" or cfg.kv_lora_rank else {"flash_attention"})
    assert want <= set(ops_["kernels"])
    if s.kind == "train":
        assert ops_["kernels"]["fused_xent"] == 1 and ops_["kernels"]["fused_xent_bwd"] == 1
    params = sum(p.numel() * p.element_size() for p in spec.model.parameters())
    batch = sum(t.numel() * t.element_size() for t in spec.args[0].values())
    assert rec["memory"]["argument_bytes"] == params + batch
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["roofline"]["model_flops"] == (6 if s.kind == "train" else 2) * \
        cfg.active_param_count() * s.seq_len * s.global_batch


def _split_reference_dots(hlo: str, vocab: int):
    """The reference's HLO with its attention dots (rank-4 batched
    products: QK^T, PV and their gradients, B5 in the port) and head dots
    (the logits h @ W and its gradients, over the vocab: B4 in the port)
    renamed out of ``analyze_hlo``'s sight; returns (text, the count of
    each)."""
    import re

    from repro.launch.hlo_analysis import _operand_names, _shape_dims, parse_computations
    types = {ins.name: ins.result_type for c in parse_computations(hlo).values()
             for ins in c.instrs}
    out, named = [], {"attention": 0, "head": 0}
    for line in hlo.splitlines():
        m = re.match(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.+?)\s+dot\((.*)$", line)
        if m:
            dims = _shape_dims(m.group(2))
            lhs = _shape_dims(types.get(_operand_names(m.group(3))[0], ""))
            k = math.prod(lhs[int(d)] for d in
                          re.search(r"lhs_contracting_dims=\{([\d,]*)\}", m.group(3))
                          .group(1).split(","))
            what = "attention" if len(dims) == 4 else "head" if vocab in dims or k == vocab \
                else None
            if what:
                named[what] += 1
                line = line.replace(" dot(", f" dot-{what}(", 1)
        out.append(line)
    return "\n".join(out), named


def test_dense_train_product_flops_match_reference_hlo(monkeypatch):
    """The dense smoke config's train step (64 tokens x 4, remat): the
    port's product FLOPs outside the kernels equal the reference's HLO dot
    FLOPs less its attention dots (8 in the scans over the layers: 2
    forward, 2 recomputed, 4 backward; the port's B5) and its head dots (3:
    the logits and their two gradients; the port's B4), within 1%."""
    import jax

    from repro.configs import get_smoke_config as ref_smoke
    from repro.launch import hlo_analysis
    from repro.launch import shapes as ref_shapes
    from repro.launch import steps as ref_steps
    from repro_torch.launch import shapes as port_shapes
    from repro_torch.launch import steps as port_steps
    tiny = InputShape("tiny_train", 64, 4, "train")
    for mod in (ref_shapes, ref_steps, port_shapes, port_steps):
        monkeypatch.setitem(mod.SHAPES, "tiny_train", tiny)
    cfg = ref_smoke("qwen3-8b")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh:
        spec = ref_steps.input_specs(cfg, "tiny_train", mesh)
        hlo = jax.jit(spec.fn, in_shardings=spec.in_shardings,
                      out_shardings=spec.out_shardings).lower(*spec.args).compile().as_text()
    rest, named = _split_reference_dots(hlo, cfg.vocab)
    assert named == {"attention": 8, "head": 3}
    want = hlo_analysis.analyze_hlo(rest).flops
    pspec = input_specs(get_smoke_config("qwen3-8b"), "tiny_train")
    with OpCounter(track_memory=False) as counter:
        pspec.fn(*pspec.args)
    got = counter.result
    assert got.product_flops == pytest.approx(want, rel=1e-2)
    assert set(got.products) == {"mm"}
    assert got.kernels == {"flash_attention": 2 * cfg.n_layers,
                           "flash_attention_bwd": cfg.n_layers,
                           "fused_xent": 1, "fused_xent_bwd": 1}


def test_bound_formulas_give_the_kernel_table_bounds():
    """PERF.md's kernel table: B1 (5, 3000, 256) aliased 4.585 us, B5 at the
    serve shape 11.74, B4 at the train shape 2,577.4, B7 at the xLSTM
    prefill shape 256.4, B6 at the serve shape 2.37."""
    b1 = roofline.bound_us(roofline.tamper_check_work(5, 3000, 256, aliased=True))
    b5 = roofline.bound_us(roofline.flash_attention_work(4, 480, 480, 32, 8, 128))
    b4 = roofline.bound_us(roofline.fused_xent_work(2048, 4096, 151936))
    b7 = roofline.bound_us(roofline.slstm_scan_work(512, 4, 2048, 4))
    b6 = roofline.bound_us(roofline.decode_attention_work(4, 512, 32, 8, 128, 0, 479))
    assert (round(b1[0], 3), b1[1]) == (4.585, "bytes")
    assert (round(b5[0], 2), b5[1]) == (11.74, "bytes")
    assert (round(b4[0], 1), b4[1]) == (2577.4, "operations")
    assert (round(b7[0], 1), b7[1]) == (256.4, "operations")
    assert (round(b6[0], 2), b6[1]) == (2.37, "bytes")


def test_live_pairs():
    assert roofline.live_pairs(5, 5) == 15
    assert roofline.live_pairs(6, 6, window=2) == 11
    assert roofline.live_pairs(3, 7, causal=False) == 21
    assert roofline.live_pairs(10, 4, window=3, causal=False) == sum(
        max(0, 4 - max(0, i - 2)) if i - 2 < 4 else 0 for i in range(10))


def test_op_counter_counts_products_and_kernel_entries():
    a, b = torch.randn(3, 5), torch.randn(5, 7)
    with OpCounter() as c:
        (a @ b).relu()
    r = c.result
    assert r.product_flops == 2 * 3 * 5 * 7 and r.products == {"mm": 210.0}
    assert r.host_transfers == {} and "float32" in r.dtypes
    q = torch.randn(1, 6, 2, 8)
    k = v = torch.randn(1, 6, 1, 8)
    with OpCounter() as c:
        ops.flash_attention(q, k, v)
    r = c.result
    work = roofline.flash_attention_work(1, 6, 6, 2, 1, 8, dtype="float32")
    assert r.kernels == {"flash_attention": 1} and r.ops == 0
    assert (r.kernel_flops, r.kernel_bytes, r.product_flops) == (work.ops, work.bytes, 0)


def test_meta_rule_gives_the_kernels_output_shapes():
    """Every entry on meta tensors: outputs of the kernel's shapes and
    dtypes, forward and backward, and nothing computed."""
    bf = torch.bfloat16
    q = torch.empty(2, 16, 4, 64, dtype=bf, device=META, requires_grad=True)
    k = torch.empty(2, 16, 2, 64, dtype=bf, device=META, requires_grad=True)
    v = torch.empty(2, 16, 2, 64, dtype=bf, device=META, requires_grad=True)
    out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == bf and out.device == META
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    h = torch.empty(2, 8, 32, dtype=bf, device=META, requires_grad=True)
    w = torch.empty(32, 100, dtype=bf, device=META, requires_grad=True)
    loss = ops.fused_cross_entropy(h, w, torch.empty(2, 8, dtype=torch.int64, device=META))
    assert loss.shape == () and loss.dtype == torch.float32
    dh, dw = torch.autograd.grad(loss, (h, w))
    assert dh.shape == h.shape and dw.shape == w.shape
    pre = torch.empty(5, 2, 4 * 8, dtype=bf, device=META, requires_grad=True)
    r = torch.empty(2, 4, 16, dtype=bf, device=META, requires_grad=True)
    hs = ops.slstm_scan(pre, r, 2)
    assert hs.shape == (5, 2, 8) and hs.dtype == bf
    dpre, dr = torch.autograd.grad(hs.sum(), (pre, r))
    assert dpre.shape == pre.shape and dr.shape == r.shape
    qd = torch.empty(2, 1, 4, 64, dtype=bf, device=META)
    assert ops.decode_attention(qd, k.detach(), v.detach(), 7).shape == qd.shape
    x = torch.empty(3, 6, 10, device=META)
    deq, scales, stats = ops.quant_roundtrip_stats(x, "int8")
    assert (deq.shape, scales.shape, stats.shape) == ((3, 6, 10), (3, 6), (3, 2))
    deq, scales = ops.quant_roundtrip(x[0], "int8")
    assert (deq.shape, scales.shape) == ((6, 10), (6,))
    passed, dists = ops.tamper_verdict(x, x, 1e-4)
    assert (passed.dtype, dists.shape) == (torch.bool, (3,))
    q, k, v = q.detach(), k.detach(), v.detach()
    with OpCounter() as c:
        ops.flash_attention(q, k, v)
    assert c.result.kernels == {"flash_attention": 1} and c.result.ops == 0


def test_dry_run_cli_records_and_refuses(tmp_path):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "h2o-danube-1.8b", "--shape", "long_500k", "--out", str(out)])
    dryrun.main(["--arch", "qwen3-8b", "--shape", "long_500k", "--out", str(out)])
    import json
    recs = json.load(open(out))
    ok = next(r for r in recs if r["arch"] == "h2o-danube-1.8b")
    assert ok["ok"] and ok["mesh"] == "1 card" and ok["chips"] == 1
    assert set(ok["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes"}
    assert ok["roofline"]["collective_s"] == 0.0 and ok["ops"]["kernels"]["decode_attention"] > 0
    assert next(r for r in recs if r["arch"] == "qwen3-8b")["skipped"]
    # the production meshes (once refused): rank 0 of a fake group of 256
    # and 512 ranks, each record with a rank's collectives by kind
    dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--mesh", "both",
                 "--out", str(out)])
    dryrun.main(["--arch", "qwen3-moe-30b-a3b", "--shape", "train_4k", "--mesh", "single",
                 "--opt", "moe_shard", "--out", str(out)])
    recs = {(r["arch"], r.get("mesh"), r.get("program")): r for r in json.load(open(out))}
    single = recs[("qwen3-8b", "16x16(data,model)", "train_step")]
    multi = recs[("qwen3-8b", "2x16x16(pod,data,model)", "pigeon_round_step")]
    moe = recs[("qwen3-moe-30b-a3b", "16x16(data,model)", "train_step+moe_shard")]
    for rec, chips in ((single, 256), (multi, 512), (moe, 256)):
        assert rec["ok"], rec.get("error")
        assert rec["chips"] == chips and rec["roofline"]["collective_s"] > 0
        ops = rec["ops"]
        assert ops["collectives_by_kind"]["all_reduce"] > 0
        assert ops["collective_bytes_per_device"] == sum(ops["collectives_by_kind"].values())
    assert multi["ops"]["collective_counts"]["all_gather"] >= 1     # the pod's losses
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="--mesh multi"):
        dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--opt", "pigeon_shardmap"])
    with pytest.raises(NotImplementedError, match="HLO"):
        dryrun.main(["--arch", "qwen3-8b", "--save-hlo", str(tmp_path)])


def test_decode_dry_run_uses_the_last_position():
    rec = dryrun.run_one("qwen3-8b", "decode_32k")
    assert rec["ok"], rec.get("error")
    cfg = get_config("qwen3-8b")
    s = SHAPES["decode_32k"]
    assert rec["ops"]["kernels"]["decode_attention"] == cfg.n_layers
    # the whole 32k cache live at S - 1: 4 D operations a key and head
    work = 4 * cfg.head_dim * s.seq_len * s.global_batch * cfg.n_heads * cfg.n_layers
    assert rec["ops"]["kernel_flops"] == work
    assert rec["roofline"]["model_flops"] == 2 * cfg.active_param_count() * s.global_batch
    assert np.isfinite(rec["roofline"]["useful_ratio"])


@pytest.fixture(scope="module")
def production_cells():
    """Every applicable (arch, shape) on both production meshes, as
    ``dryrun --all --mesh both`` runs them."""
    from repro_torch.launch.shapes import applicable
    return [dryrun.run_one(arch, shape, multi_pod=mp) for arch in list_archs()
            for shape in SHAPES if applicable(arch, shape)[0] for mp in (False, True)]


def _kv_layers(cfg) -> int:
    """The layers whose decode step runs B6 (a GQA KV cache): MLA's
    absorbed decode and the mixers run none."""
    from repro_torch.models.model import build_plan
    if cfg.kv_lora_rank:
        return 0
    return sum(sp.n for sp in build_plan(cfg)
               if sp.kind in ("attn_mlp", "dense_mlp", "moe", "dec_cross", "shared_attn"))


def _panelled(cfg, shape, m: int = 16) -> bool:
    """Whether a rank's decode cache is a panel of the sequence at model m
    (the reference's ``cache_shardings``): a batch of 1 (its sequence over
    the data axes), MLA's latent (no head axis), a KV head that several
    model ranks share or heads that m does not divide (the block whole)."""
    return (shape.global_batch == 1 or bool(cfg.kv_lora_rank)
            or cfg.n_heads % m != 0 or cfg.n_kv_heads % m != 0)


def _departing(arch: str, m: int = 16) -> set:
    """The leaves (reference paths) whose layout at model m departs from
    the reference's spec, as ``test_torch_shardings._documented_layout``
    names them."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import shardings as tsh
    from repro_torch.models.model import Model, build_plan
    from test_torch_shardings import _documented_layout, _leaves
    cfg = get_config(arch)
    plan = build_plan(cfg)
    mesh = tmesh.abstract_mesh((1, m), ("data", "model"))
    specs = tsh.param_shardings(Model(cfg, plan, torch.device("meta"), par=mesh.parallel()),
                                mesh)
    out = set()
    for path, spec in specs.items():
        want = (spec.index("model") - len(spec), m, None) if "model" in spec else None
        if _documented_layout(cfg, plan, m, path, want) != want:
            out.add(path)
    return out


def test_production_meshes_pass_every_cell(production_cells):
    """Every one of the 68 cells passes, every layer kind at model 16: the
    sequence-sharded caches, the whole layers, MLA, Mamba2 and the shared
    block, mLSTM/sLSTM and the encoder-decoder.  A decode cell runs B6 once
    a GQA layer: its partial mode, with an all-gather of the partials a
    layer, where the rank's cache is a panel of the sequence, else the
    whole-cache kernel; MLA's absorbed decode gathers the heads' queries
    and the partials a layer.  Every cell records the parameters' bytes a
    rank beside the reference spec's, departing only on the leaves
    ``_documented_layout`` names."""
    ok = [r for r in production_cells if r["ok"]]
    assert (len(production_cells), len(ok)) == (68, 68), [
        (r["arch"], r["shape"], r["mesh"], r["error"]) for r in production_cells if not r["ok"]]
    departing = {arch: _departing(arch) for arch in {r["arch"] for r in ok}}
    for r in ok:
        cell = (r["arch"], r["shape"], r["mesh"])
        assert r["memory"]["argument_bytes"] > 0, cell
        assert sum(r["ops"]["collectives_by_kind"].values()) == \
            r["ops"]["collective_bytes_per_device"] > 0, cell
        pb = r["memory"]["param_bytes"]
        assert pb["held"] > 0 and pb["spec"] > 0, cell
        assert set(pb["departures"]) <= departing[r["arch"]], cell
        if r["arch"] == "xlstm-1.3b":
            # its 4 heads at 16: the mixers whole
            assert (round(pb["held"] / 1e9, 3), round(pb["spec"] / 1e9, 3)) == \
                (6.673, 0.680), cell
        shape = SHAPES[r["shape"]]
        if shape.kind != "decode":
            continue
        cfg = get_config(r["arch"])
        kernels, gathers = r["ops"]["kernels"], r["ops"]["collective_counts"].get("all_gather", 0)
        kv = _kv_layers(cfg)
        if cfg.kv_lora_rank:
            assert "decode_attention" not in kernels and "decode_attention_partial" not in kernels
            assert gathers >= 2 * cfg.n_layers, cell
        elif _panelled(cfg, shape):
            assert kernels.get("decode_attention_partial", 0) == kv, cell
            assert "decode_attention" not in kernels and gathers >= kv, cell
        else:
            assert kernels.get("decode_attention", 0) == kv, cell
            assert "decode_attention_partial" not in kernels, cell


def test_seq_shard_cache_record(tmp_path):
    """``--seq-shard-cache`` writes a ``+seq_shard_cache`` record; a batch-1
    cache takes the layout anyway (the reference's input_specs)."""
    import json
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k", "--mesh", "single",
                 "--seq-shard-cache", "--out", str(out)])
    dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k", "--mesh", "single",
                 "--out", str(out)])
    recs = {r["program"]: r for r in json.load(open(out))}
    sharded, plain = recs["serve_step+seq_shard_cache"], recs["serve_step"]
    assert sharded["ok"] and plain["ok"]
    assert sharded["memory"]["argument_bytes"] <= plain["memory"]["argument_bytes"]
    spec = input_specs(get_config("gemma3-12b"), "long_500k")
    assert spec.args[0].panels.rows_whole is False         # one card: nothing to split
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    with fake_group(256):
        spec = input_specs(get_config("gemma3-12b"), "long_500k", make_production_mesh())
        panels = spec.args[0].panels
        assert panels.rows_whole and panels.count == 16 * 2 and panels.length == 524_288 // 32
