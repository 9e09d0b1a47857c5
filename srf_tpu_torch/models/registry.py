"""Model dispatch (port of ``srf_tpu/models/registry.py``, the SRF and CNN
families).

Reference: tfsr/trainer_sr.py:175-201. ``--model-type`` "cnn"/"conv"/
"convolution" selects the maxout CNN (the maxpool or the stride variant on
``--model-conv-is-mp``); anything else but the LSTM and STF types, which
this port has not reached, is SRF. ``in_len_div`` (the time-subsampling
divisor used for CTC lengths) is ``conv_stride ** conv_layer_num`` for
both families. Every ``--tpu-routing-kernel`` value but ``wavefront`` runs
the port's one SDR (an unknown value raises ``ValueError``, as in JAX).
Model types and flags not ported yet raise ``NotImplementedError`` instead
of running something else.
"""

from srf_tpu_torch.models.cnn import CNNEncoder, CNNStrideEncoder
from srf_tpu_torch.models.srf import SequenceRouter

_LATER = "not ported yet: %s is a later slice of the PyTorch port"
CNN_TYPES = ("cnn", "conv", "convolution")
DROPOUT_IMPLS = ("xla", "pallas")
# --tpu-routing-kernel values that build the SRF (wavefront: refused)
ROUTING_KERNELS = ("auto", "xla", "xla_flat", "xla_pre", "xla_factored",
                   "pallas")


def validate_dropout_kernel(config, model_type):
    """--tpu-dropout-kernel: ``xla`` or ``pallas``; the fused dropout (K5)
    is wired to the CNN family only, so asking for it elsewhere is refused
    rather than ignored (``srf_tpu/models/registry.py:64-78``)."""
    impl = getattr(config, "tpu_dropout_kernel", "xla") or "xla"
    if impl not in DROPOUT_IMPLS:
        raise ValueError("unknown --tpu-dropout-kernel %r" % impl)
    if impl == "pallas" and model_type not in CNN_TYPES:
        raise ValueError(
            "--tpu-dropout-kernel=pallas is wired to the CNN family only "
            "(model-type %r would silently ignore it)" % model_type
        )
    return impl


def build_model(config, dec_out_dim, logger=None, **overrides):
    """Returns (model, in_len_div)."""
    model_type = (config.model_type or "srf").lower()
    validate_dropout_kernel(config, model_type)
    if model_type.endswith("lstm") or model_type == "stf":
        raise NotImplementedError(_LATER % ("--model-type=" + model_type))
    in_len_div = config.model_conv_stride ** config.model_conv_layer_num
    if model_type in CNN_TYPES:
        encoder = CNNEncoder if config.model_conv_is_mp else CNNStrideEncoder
        model = encoder.from_config(config, dec_out_dim, **overrides)
        return model, in_len_div
    if config.model_caps_layer_time is not None:
        if logger is not None:
            logger.critical("LSRF is deprecated")
        raise ValueError("LSRF (model-caps-layer-time) is deprecated")
    if config.model_caps_type not in ("lowmemory", "einsum", "naive"):
        raise ValueError("unknown caps type %s" % config.model_caps_type)
    # every value but wavefront computes the same function
    # (srf_tpu/ops/routing.py:643-691); the port has one SDR for them,
    # SDRFunction: K1/K2 on CUDA, the plain loop on the CPU
    kernel = getattr(config, "tpu_routing_kernel", "auto")
    if kernel not in ROUTING_KERNELS + ("wavefront",):
        raise ValueError("unknown --tpu-routing-kernel %r" % kernel)
    if kernel == "wavefront":
        raise NotImplementedError(_LATER % "--tpu-routing-kernel=wavefront")
    if getattr(config, "tpu_routing_bf16", False):
        if kernel in ("pallas", "xla_flat"):
            raise ValueError(
                "--tpu-routing-kernel=%s does not support bf16 routing or "
                "time chunking; use auto/xla/xla_pre" % kernel)
        raise NotImplementedError(_LATER % "--tpu-routing-bf16")
    model = SequenceRouter.from_config(config, dec_out_dim, **overrides)
    if logger is not None:
        logger.info(
            "Layer x %d, Iter x %s, Win %d (l:%d, r:%d), %s",
            config.model_encoder_num,
            "1 (fixed)" if config.model_caps_type == "lowmemory"
            else str(config.model_caps_iter),
            config.model_caps_window_lpad + config.model_caps_window_rpad + 1,
            config.model_caps_window_lpad,
            config.model_caps_window_rpad,
            "SDR" if config.model_caps_context else "DR",
        )
    return model, in_len_div
