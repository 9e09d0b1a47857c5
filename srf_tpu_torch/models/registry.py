"""Model dispatch (port of ``srf_tpu/models/registry.py``).

Reference: tfsr/trainer_sr.py:175-201. ``--model-type`` ending in "lstm"
selects the LSTM encoder ("blstm" bidirectional); "cnn"/"conv"/
"convolution" the maxout CNN (the maxpool or the stride variant on
``--model-conv-is-mp``); "stf" the Speech-Transformer, which the reference
builds in trainer_tf (trainer_tf.py:286-293); anything else is SRF.
``in_len_div`` (the time-subsampling divisor used for CTC lengths) is
``conv_stride ** conv_layer_num`` for the SRF, CNN and STF families and the
LSTM's own property. Every ``--tpu-routing-kernel`` value but
``wavefront`` runs the port's one SDR; ``wavefront`` runs the whole stack
as one loop over time (``ops/routing.wavefront_sdr_stack``); an unknown
value raises ``ValueError``, as in JAX.
"""

from srf_tpu_torch.models.cnn import CNNEncoder, CNNStrideEncoder
from srf_tpu_torch.models.lstm import LstmEncoder
from srf_tpu_torch.models.srf import BF16_REFUSAL, SequenceRouter
from srf_tpu_torch.models.stf import ConvEncoder

CNN_TYPES = ("cnn", "conv", "convolution")
DROPOUT_IMPLS = ("xla", "pallas")
# --tpu-routing-kernel values that build the SRF on its one SDR
# (wavefront builds the stack loop)
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


def stf_in_len_div(config, logger=None):
    """Time-subsampling divisor of the STF, shared by ``build_model`` and
    ``trainer_tf`` so CTC lengths and mask shapes agree.

    The reference computes ``conv_layer_num ** conv_stride``
    (tfsr/trainer_tf.py:302), transposed from trainer_sr's ``conv_stride
    ** conv_layer_num``. Both are 4 at the defaults (2, 2); for any other
    geometry the reference formula disagrees with the front end's actual
    subsampling, so the true one is used and the difference is logged.
    """
    true_div = config.model_conv_stride ** config.model_conv_layer_num
    ref_div = config.model_conv_layer_num ** config.model_conv_stride
    if ref_div != true_div and logger is not None:
        logger.warning(
            "STF in_len_div: using the front-end's true subsampling %d; "
            "the reference formula (layer_num ** stride, "
            "tfsr/trainer_tf.py:302) would give %d for conv geometry "
            "(%d layers, stride %d) and mis-size the CTC lengths",
            true_div, ref_div,
            config.model_conv_layer_num, config.model_conv_stride,
        )
    return true_div


def validate_stf_attention_kernel(config):
    """--tpu-attention-kernel: auto, plain or blockwise; ``ring`` needs a
    process group over the time axis that the CLIs do not build, and an
    unknown value would silently run the plain path, so both raise JAX's
    ``ValueError``. Returns the kernel."""
    att_kernel = getattr(config, "tpu_attention_kernel", "auto")
    if att_kernel == "ring":
        raise ValueError(
            "--tpu-attention-kernel=ring is programmatic-only: ring "
            "(sequence-parallel) attention needs a device mesh, which "
            "the CLI trainers do not construct for the time axis. "
            "Build ConvEncoder(attention_impl='ring', group=...) "
            "directly (see srf_tpu_torch/ops/ring_attention.py)."
        )
    if att_kernel not in ("auto", "plain", "blockwise"):
        raise ValueError("unknown --tpu-attention-kernel %r" % att_kernel)
    return att_kernel


def build_model(config, dec_out_dim, logger=None, **overrides):
    """Returns (model, in_len_div)."""
    model_type = (config.model_type or "srf").lower()
    validate_dropout_kernel(config, model_type)
    if model_type.endswith("lstm"):
        model = LstmEncoder.from_config(config, dec_out_dim, **overrides)
        return model, model.in_len_div
    if model_type == "stf":
        in_len_div = stf_in_len_div(config, logger)
        validate_stf_attention_kernel(config)
        return ConvEncoder.from_config(config, dec_out_dim,
                                       **overrides), in_len_div
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
        overrides.setdefault("routing_impl", "wavefront")
    if getattr(config, "tpu_routing_bf16", False):
        # JAX refuses the wavefront's in the model's forward (so does the
        # port's); here it is refused before a model is built
        if kernel in ("pallas", "xla_flat", "wavefront"):
            raise ValueError(BF16_REFUSAL % kernel)
        # the rounding points of JAX's materialized scan (impl="xla") for
        # every other kernel value; JAX's auto path rounds elsewhere (F19)
        overrides.setdefault("routing_bf16", True)
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
