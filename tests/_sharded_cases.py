"""The driver cases of ``tests/test_torch_sharded.py``, shared by the
reference's oracle (``tests/_sharded_oracle.py``, a JAX subprocess) and the
port's ranks (``tests/_sharded_ranks.py``, torch only): one table, run
through either package's drivers, which share their names and arguments.
Imports neither package."""
import dataclasses

TASK = dict(m_clients=4, d_m=120, d_o=60, n_test=200, seed=0)
#: the tiny MNIST protocol, R = 4 clusters
PCFG = dict(M=4, N=3, T=2, E=2, B=16, lr=0.05, seed=0)
SEEDS = (0, 1, 2, 3)
LR = 0.05
#: the LM round step: R slots of (B, S) batches, a (D_o, S) validation set
LM = dict(arch="qwen3-8b", r=2, k=2, b=2, s=16, d_o=4)

#: case -> (driver, driver kwargs, ProtocolConfig overrides)
CASES = {
    "honest": ("pigeon", dict(), dict()),
    "label_flip": ("pigeon", dict(malicious={1}, attack="label_flip"), dict()),
    "int8_loss_plus_distance": ("pigeon", dict(malicious={1}, attack="label_flip",
                                               quant="int8",
                                               selection="loss_plus_distance"), dict()),
    "param_tamper": ("pigeon", dict(malicious={2, 3}, attack="param_tamper"), dict()),
    "plus": ("pigeon", dict(malicious={1}, attack="label_flip", plus=True), dict()),
    "splitfed": ("splitfed", dict(malicious={1}, attack="label_flip"), dict()),
    "block1": ("pigeon", dict(malicious={1}, attack="label_flip"),
               dict(T=4, eval_every=2)),
    "block2_prefetch1": ("pigeon", dict(malicious={1}, attack="label_flip", block=2,
                                        prefetch=1), dict(T=4, eval_every=2)),
    "sweep": ("sweep", dict(malicious={1}, attack="label_flip", seeds=(0, 1), block=2),
              dict(N=1, T=3, eval_every=3)),
    "pool": ("pool", dict(block=2), dict(N=1)),
}
#: the port's runs held against another port run bit for bit instead of the
#: reference (the reference runs the case on its right)
BIT_EQUAL = {"block2_prefetch1": "block1"}
#: the reference's runs of a case differ in these arguments only: its
#: sweep_block compiles a second program, and the block changes no outcome
REFERENCE_KW = {"sweep": dict(block=1)}
#: the pool's jobs: (seed, T, threat)
POOL_JOBS = ((0, 2, {}), (1, 2, dict(malicious={1}, attack="label_flip")),
             (2, 3, {}), (3, 3, dict(malicious={0}, attack="label_flip")))


def _attack(core, kw):
    kw = dict(kw)
    kind = kw.pop("attack", None)
    if kind is not None:
        kw["attack"] = core.Attack(kind)
    return kw


def run_case(core, module, data, name, placement="sharded", **extra):
    """Case ``name`` through ``core``'s drivers (``extra``: the port's
    ``device``, or the reference's ``REFERENCE_KW``).  Returns the rounds: a
    list of records, the sweep's a list a seed, the pool's a dict a job."""
    driver, kw, over = CASES[name]
    pcfg = core.ProtocolConfig(**dict(PCFG, **over))
    kw = dict(_attack(core, kw), placement=placement, **extra)
    if driver == "pigeon":
        return core.run_pigeon(module, data, pcfg, engine="batched", **kw).rounds
    if driver == "splitfed":
        return core.run_splitfed(module, data, pcfg, engine="batched", **kw).rounds
    if driver == "sweep":
        return [h.rounds for h in core.run_pigeon_sweep(module, data, pcfg, **kw)]
    specs = [core.JobSpec(name=f"job{s}", module=module, data=data,
                          pcfg=dataclasses.replace(pcfg, seed=s, T=t, eval_every=t),
                          **_attack(core, threat))
             for s, t, threat in POOL_JOBS]
    hists = core.run_job_pool(specs, **kw)
    return {k: h.rounds for k, h in sorted(hists.items())}
