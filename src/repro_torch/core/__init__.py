"""Paper core: distortion approximation, rate-distortion bounds, quantizers,
and the joint bit-width x frequency co-design (paper §III-§V); the port of
``repro/core``, with the same exports.

The names resolve on first use (PEP 562): the kernels import
``core.quantization`` and ``core.mixed_precision`` imports the models,
which import the kernels, so importing every submodule here would close
that cycle."""

import importlib

_EXPORTS = {
    "cost_model": ("SystemParams", "total_delay", "total_energy",
                   "transport_delay", "transport_energy"),
    "codesign": ("CodesignSolution", "distortion_gap", "solve_oracle",
                 "solve_sca", "feasible_bitwidth",
                 "min_energy_under_deadline", "net_budgets"),
    "baselines": ("solve_fixed_frequency", "solve_feasible_random",
                  "solve_ppo"),
    "quantization": ("QuantConfig", "QuantPlan", "QuantizedTensor",
                     "quantize", "dequantize", "quantize_dequantize",
                     "quantize_tree", "quantize_tree_stacked",
                     "fake_quantize_tree", "qat_quantize", "max_quant_error",
                     "pack_int4", "unpack_int4", "as_plan", "wire_bytes"),
    "fleet": ("FleetAgent", "FleetSolution", "min_share_for",
              "shared_params", "solve_equal_split", "solve_fleet"),
    "mixed_precision": ("LayerStats", "MixedSolution", "decoder_layer_stats",
                        "allocate_bits", "best_uniform_bits",
                        "max_mean_bits", "allocation_objective",
                        "uniform_objective", "plan_from_bits"),
    "rate_distortion": ("exponential_mle", "exponential_entropy",
                        "rate_lower_bound", "rate_upper_bound",
                        "distortion_lower_bound", "distortion_upper_bound",
                        "blahut_arimoto_distortion_rate"),
    "distortion": ("induced_l1_norm", "param_distortion",
                   "chain_bound_coefficients", "fc_chain_bound",
                   "measured_output_distortion", "taylor_surrogate_bound",
                   "estimate_grad_norm_H"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_WHERE[name]}", __name__),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
