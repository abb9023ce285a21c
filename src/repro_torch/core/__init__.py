"""Split-learning core: the cut-layer exchange, validation, clustering, wire
accounting, the batched round runner and the Pigeon-SL drivers.  The
adversaries come from :mod:`repro_torch.adversary`, the selection policies
from :mod:`repro_torch.selection`; both are re-exported here under the
reference's names."""
from ..adversary import (ALWAYS, BACKDOOR, GRAD_NOISE, GRAD_SCALE, REPLAY, STEALTH,
                         ClientThreat, Schedule, ThreatModel, after_warmup, every_k, ramp,
                         stealth)
from ..selection import (LossPlusDistancePolicy, MedianOfMeansPolicy, SelectionPolicy,
                         TrimmedPolicy, resolve_policy, selection_policies)
from ..telemetry import Telemetry

from .attacks import (ACTIVATION, GRADIENT, HONEST, KINDS, LABEL_FLIP, NONE, PARAM_TAMPER,
                      Attack, AttackVec, attack_vec, attack_vec_for_clusters)
from .clustering import cluster_is_honest, has_honest_cluster, make_clusters
from .compile_cache import compile_cache_stats, enable_compile_cache
from .comm import QUANT_FORMATS, CommConfig, fp8_supported, message_bytes, resolve_quant
from .engine import run_pigeon_sweep, train_round_batched
from .jobs import JobPool, JobSpec, run_job_pool
from .protocol import (ENGINES, PLACEMENTS, ClientData, CommMeter, History,
                       ProtocolConfig, check_block, evaluate, run_pigeon, run_pigeon_plus,
                       run_splitfed, run_vanilla_sl, train_cluster)
from .runner import (RoundRunner, RoundSpec, VerifyConfig, check_partial_auto_backend,
                     cluster_map, cluster_mesh, onehot_select, protocol_accept_runner,
                     protocol_round_spec, protocol_runner, select_map, sweep_map,
                     sweep_mesh)
from .split import (SplitModule, client_update, client_update_stats, from_cnn, from_lm,
                    message_stats, sgd_update, sl_minibatch_grads, sl_minibatch_grads_vec)
from .validation import (check_handoff, handoff_activations, select_cluster,
                         validation_loss)

__all__ = [
    "Attack", "HONEST", "NONE", "LABEL_FLIP", "ACTIVATION", "GRADIENT",
    "PARAM_TAMPER", "BACKDOOR", "GRAD_SCALE", "GRAD_NOISE", "REPLAY",
    "STEALTH", "stealth", "KINDS",
    "AttackVec", "attack_vec", "attack_vec_for_clusters",
    "ThreatModel", "ClientThreat", "Schedule", "ALWAYS", "every_k",
    "after_warmup", "ramp",
    "make_clusters", "has_honest_cluster", "cluster_is_honest",
    "ClientData", "CommMeter", "CommConfig", "QUANT_FORMATS", "fp8_supported",
    "message_bytes", "resolve_quant", "History", "ProtocolConfig", "ENGINES",
    "Telemetry", "check_block", "evaluate", "train_cluster",
    "run_pigeon", "run_pigeon_plus", "run_splitfed", "run_vanilla_sl",
    "run_pigeon_sweep", "train_round_batched", "onehot_select",
    "PLACEMENTS", "RoundRunner", "RoundSpec", "VerifyConfig", "cluster_map",
    "select_map", "sweep_map", "protocol_round_spec", "protocol_runner",
    "cluster_mesh", "sweep_mesh", "check_partial_auto_backend",
    "protocol_accept_runner", "JobSpec", "JobPool", "run_job_pool",
    "SelectionPolicy", "MedianOfMeansPolicy", "LossPlusDistancePolicy",
    "TrimmedPolicy", "resolve_policy", "selection_policies",
    "SplitModule", "client_update", "client_update_stats", "from_cnn", "from_lm",
    "message_stats", "sgd_update", "sl_minibatch_grads", "sl_minibatch_grads_vec",
    "check_handoff", "handoff_activations", "select_cluster", "validation_loss",
    "enable_compile_cache", "compile_cache_stats",
]
