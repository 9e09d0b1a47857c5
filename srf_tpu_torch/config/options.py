"""Config / CLI flag system.

Two-level configuration identical in behavior to the reference
(reference: tfsr/helper/common_helper.py:134-459):

- flags may come from a ``--config=<file>.conf`` argparse @-file and/or the
  command line; **command line wins** for any flag explicitly given there
  (reference: common_helper.py:176-179),
- the conf file must end in ``.conf`` (reference: common_helper.py:152-156)
  and is resolved relative to ``--path-base`` when not found as given,
- the same ~70 flag registry, grouped train-/prep-/path-/feat-/model-/
  decoding-, with identical names, types and defaults, plus an additive
  ``tpu-*`` group for TPU-native capabilities (mesh shape, dtype policy,
  kernel selection) that has no reference analog.

This is the PyTorch port's own copy of ``srf_tpu/config/options.py``: the
same flags, defaults and conf-file merge, so conf files and recipes parse
identically, plus one flag, ``--device`` (default ``cuda``), that picks
where the port runs.
"""

import argparse
import os
import sys

from srf_tpu_torch.config.constants import Constants, ExitCode


class ParseOption:
    """Merges options from a conf file and the command line."""

    def __init__(self, argv, logger, is_print_opts=True):
        self.logger = logger
        parser = self.build_parser()

        # flags explicitly present on the command line (normalized to _)
        command_keys = set()
        for command_key in argv[1:]:
            eq = command_key.find("=")
            end = eq if eq >= 0 else len(command_key)
            command_keys.add(command_key[2:end].replace("-", "_"))

        if len(argv) <= 1:
            self.logger.critical("no arguments given — pass --config and/or flags")
            sys.exit(ExitCode.INVALID_OPTION.value)

        command_args = parser.parse_args(argv[1:])

        if command_args.config is not None and not command_args.config.endswith(".conf"):
            self.logger.critical(
                "config file must use the .conf extension (got %s)",
                command_args.config,
            )
            sys.exit(ExitCode.INVALID_NAME_OF_CONFIGURATION_FILE.value)

        command_dict = vars(command_args)
        if command_args.config:
            if "config" not in command_keys:
                self.logger.critical('--config must be passed on the command line itself')
                sys.exit(ExitCode.INVALID_OPTION.value)
            file_path = command_args.config
            if command_args.path_base and not os.path.exists(file_path):
                file_path = command_args.path_base + "/" + file_path
            config_dict = vars(parser.parse_args(["@" + file_path]))
            for arg_key in command_dict:
                if arg_key not in command_keys:
                    command_dict[arg_key] = config_dict[arg_key]

        args = argparse.Namespace(**command_dict)

        if not self.sanity_check(args):
            sys.exit(ExitCode.INVALID_OPTION.value)
        if is_print_opts:
            self.print_args(args)
        self._args = args

    @staticmethod
    def str2bool(bool_string):
        return bool_string.lower() in ("yes", "true", "t", "1")

    @staticmethod
    def str2list_int(list_string):
        if list_string is None:
            return list_string
        return list(
            map(
                int,
                list_string.replace('"', "").replace("[", "").replace("]", "").split(","),
            )
        )

    @property
    def args(self):
        return self._args

    def sanity_check(self, args):
        if args.model_caps_type not in ["lowmemory", "einsum", "naive"]:
            self.logger.critical(
                "unknown --model-caps-type %r (choices: lowmemory, einsum, naive)",
                args.model_caps_type,
            )
            return False

        if not args.path_base:
            self.logger.critical("--path-base is required")
            return False

        if not os.path.isdir(args.path_base):
            self.logger.critical(
                "--path-base %s is not an existing directory",
                args.path_base,
            )
            return False

        if args.train_schedule_prob is not None and not 0 <= args.train_schedule_prob < 2:
            self.logger.critical(
                "--train-schedule-prob %f is outside [0, 2)",
                args.train_schedule_prob,
            )
            return False

        if args.train_smoothing_type not in (Constants.SM_LABEL, Constants.SM_NEIGHBOR):
            self.logger.critical(
                "unknown --train-smoothing-type %s", args.train_smoothing_type
            )
            return False

        if not args.train_is_mwer and (args.prep_max_inp > 0 or args.prep_max_tar > 0):
            self.logger.warning(
                "prep-max-inp %d / prep-max-tar %d are set without "
                "--train-is-mwer; length filtering is meant for MWER runs",
                args.prep_max_inp,
                args.prep_max_tar,
            )

        return True

    def print_args(self, args):
        self.logger.info("********************************************")
        self.logger.info("  Sequential Routing Framework (PyTorch)    ")
        self.logger.info("********************************************")
        pre_name = ""
        for arg in sorted(vars(args)):
            name = arg.split("_")[0]
            if name != pre_name:
                self.logger.info(". %s", name.upper())
                pre_name = name
            self.logger.info("- %s=%s", arg, getattr(args, arg))
        self.logger.info("*********************************************")

    @staticmethod
    def build_parser():
        parser = argparse.ArgumentParser(
            description="TPU-native Sequential Routing Framework",
            fromfile_prefix_chars="@",
            # abbreviated flags would desync argparse's parse from the
            # string-derived command_keys set that implements the
            # "command line wins over conf file" merge: --train-max-epo=50
            # would parse as train_max_epoch yet be OVERWRITTEN by the
            # conf value. Full flag names only.
            allow_abbrev=False,
        )
        parser.add_argument("--config", help="options can be loaded from this config file")

        # Hyper-parameters for training
        train_group = parser.add_argument_group(title="training")
        train_group.add_argument("--train-inp-dropout", type=float, default=0.1)
        train_group.add_argument("--train-inn-dropout", type=float, default=0.1)
        train_group.add_argument("--train-att-dropout", type=float, default=0.1)
        train_group.add_argument("--train-res-dropout", type=float, default=0.1)
        train_group.add_argument("--train-ckpt-saving-per", type=int, default=1)
        train_group.add_argument("--train-es-min-delta", type=float, default=0.001)
        train_group.add_argument("--train-es-tolerance", type=int, default=1)
        train_group.add_argument("--train-lr-param-k", type=float, default=None)
        train_group.add_argument("--train-max-epoch", type=int, default=None)
        train_group.add_argument("--train-adam-beta1", type=float, default=0.9)
        train_group.add_argument("--train-adam-beta2", type=float, default=0.98)
        train_group.add_argument("--train-adam-epsilon", type=float, default=1e-09)
        train_group.add_argument("--train-warmup-n", type=int, default=25000)
        train_group.add_argument("--train-ppl-step", type=int, default=1)
        train_group.add_argument("--train-max-step", type=int, default=0)
        train_group.add_argument("--train-opti-type", default=None)
        train_group.add_argument("--train-smoothing-confidence", type=float, default=0.0)
        train_group.add_argument("--train-smoothing-type", default=Constants.SM_NEIGHBOR)
        train_group.add_argument("--train-schedule-prob", type=float, default=None)
        train_group.add_argument("--train-batch-size", type=int, default=26)
        train_group.add_argument("--train-batch-frame", type=int, default=20000)
        train_group.add_argument("--train-lr-max", type=float, default=1e3)
        train_group.add_argument(
            "--train-batch-dynamic", type=ParseOption.str2bool, default="False"
        )
        train_group.add_argument("--train-is-mwer", type=ParseOption.str2bool, default="false")
        train_group.add_argument(
            "--train-batch-buckets", type=ParseOption.str2list_int, default=None
        )

        # Preprocess
        prep_group = parser.add_argument_group(title="Pre-processing")
        prep_group.add_argument("--prep-data-shard", type=int, default=100)
        prep_group.add_argument("--prep-data-name", default="wsj")
        prep_group.add_argument("--prep-data-unit", default="char")
        prep_group.add_argument("--prep-data-bos", type=ParseOption.str2bool, default="True")
        prep_group.add_argument(
            "--prep-data-pad-space", type=ParseOption.str2bool, default="True"
        )
        prep_group.add_argument("--prep-max-tar", type=int, default=-1)
        prep_group.add_argument("--prep-max-inp", type=int, default=-1)
        prep_group.add_argument("--prep-data-num-train", type=int, default=None)
        prep_group.add_argument("--prep-data-num-valid", type=int, default=None)
        prep_group.add_argument("--prep-data-num-test", type=int, default=None)

        # Path
        path_group = parser.add_argument_group(title="path")
        path_group.add_argument("--path-base", help="base path")
        path_group.add_argument("--path-ckpt", default=None, help="checkpoint")
        path_group.add_argument("--path-ckpt-epoch", type=int, default=0)
        path_group.add_argument("--path-cmvn-ptrn", default=None)
        path_group.add_argument("--path-vocab", help="vocab file")
        path_group.add_argument("--path-hyp", help="recognized text file")
        path_group.add_argument("--path-train-ptrn", default=None)
        path_group.add_argument("--path-test-ptrn", default=None)
        path_group.add_argument("--path-valid-ptrn", default=None)
        path_group.add_argument("--path-train-json", default=None)
        path_group.add_argument("--path-valid-json", default=None)
        path_group.add_argument("--path-test-json", default=None)
        path_group.add_argument("--path-wrt-tfrecord", default=None)

        # Feature
        feature_group = parser.add_argument_group(title="feature")
        feature_group.add_argument("--feat-type", default=None, help="stf, stfraw")
        feature_group.add_argument("--feat-dim", type=int, default=None)
        feature_group.add_argument("--feat-dim1", type=int, default=None)
        feature_group.add_argument("--feat-dim2", type=int, default=None)

        # Model architecture
        model_group = parser.add_argument_group(title="model architecture")
        model_group.add_argument("--model-encoder-num", type=int, default=None)
        model_group.add_argument("--model-decoder-num", type=int, default=None)
        model_group.add_argument("--model-res-enc", type=int, default=1)
        model_group.add_argument("--model-res-dec", type=int, default=1)
        model_group.add_argument("--model-dimension", type=int, default=1)
        model_group.add_argument("--model-inner-dim", type=int, default=2048)
        model_group.add_argument("--model-inner-num", type=int, default=3)
        model_group.add_argument("--model-att-head-num", type=int, default=4)
        model_group.add_argument("--model-conv-filter-num", type=int, default=64)
        model_group.add_argument("--model-conv-layer-num", type=int, default=2)
        model_group.add_argument("--model-conv-stride", type=int, default=2)
        model_group.add_argument("--model-ckpt-max-to-keep", type=int, default=-1)
        model_group.add_argument(
            "--model-shared-embed", type=ParseOption.str2bool, default="False"
        )
        model_group.add_argument("--model-conv-mask-type", type=int, default=None)
        model_group.add_argument("--model-ap-scale", type=float, default=None)
        model_group.add_argument("--model-ap-width-zero", type=int, default=None)
        model_group.add_argument("--model-ap-width-stripe", type=int, default=None)
        model_group.add_argument("--model-average-num", type=int, default=None)
        model_group.add_argument("--model-ap-encoder", type=ParseOption.str2bool, default="False")
        model_group.add_argument("--model-ap-decoder", type=ParseOption.str2bool, default="False")
        model_group.add_argument("--model-ap-encdec", type=ParseOption.str2bool, default="False")
        model_group.add_argument("--model-type", default="srf")
        model_group.add_argument("--model-initializer", default=None)
        model_group.add_argument("--model-emb-sqrt", type=ParseOption.str2bool, default="True")
        model_group.add_argument(
            "--model-caps-context", type=ParseOption.str2bool, default="True"
        )
        model_group.add_argument(
            "--model-lstm-is-cnnfe", type=ParseOption.str2bool, default="False"
        )
        model_group.add_argument("--model-lstm-merge", default="ave")
        model_group.add_argument("--model-caps-type", default="lowmemory")
        model_group.add_argument("--model-caps-iter", type=int, default=2)
        model_group.add_argument("--model-caps-primary-num", type=int, default=3)
        model_group.add_argument("--model-caps-primary-dim", type=int, default=2)
        model_group.add_argument("--model-caps-convolution-num", type=int, default=4)
        model_group.add_argument("--model-caps-convolution-dim", type=int, default=4)
        model_group.add_argument("--model-caps-class-dim", type=int, default=64)
        model_group.add_argument("--model-caps-window-lpad", type=int, default=None)
        model_group.add_argument("--model-caps-window-rpad", type=int, default=None)
        model_group.add_argument("--model-caps-layer-num", type=int, default=2)
        model_group.add_argument("--model-caps-layer-time", type=int, default=None)
        model_group.add_argument(
            "--model-caps-res-connection", type=ParseOption.str2bool, default="False"
        )
        model_group.add_argument("--model-conv-is-mp", type=ParseOption.str2bool, default="False")
        model_group.add_argument("--model-conv-inp-nfilt", type=int, default=64)
        model_group.add_argument("--model-conv-inn-nfilt", type=int, default=128)
        model_group.add_argument("--model-conv-proj-num", type=int, default=3)
        model_group.add_argument("--model-conv-proj-dim", type=int, default=512)

        # Decoding
        decoding_group = parser.add_argument_group(title="decoding")
        decoding_group.add_argument("--decoding-beam-width", type=int, default=None)
        decoding_group.add_argument("--decoding-lp-alpha", type=float, default=None)
        decoding_group.add_argument(
            "--decoding-from-npy", type=ParseOption.str2bool, default="False"
        )

        # TPU-native additions (no reference analog; additive group)
        tpu_group = parser.add_argument_group(title="tpu")
        tpu_group.add_argument(
            "--tpu-bf16", type=ParseOption.str2bool, default="False",
            help="bfloat16 compute (params stay float32)",
        )
        tpu_group.add_argument(
            "--tpu-async-ckpt", type=ParseOption.str2bool, default="False",
            help="background the per-epoch checkpoint disk write (orbax "
                 "async); the device->host copy stays synchronous, so "
                 "training math is unchanged",
        )
        tpu_group.add_argument(
            "--tpu-mesh-data", type=int, default=-1,
            help="data-parallel mesh size; -1 = all visible devices",
        )
        tpu_group.add_argument(
            "--tpu-ckpt-every-steps", type=int, default=0,
            help="preemption-safe mid-epoch checkpointing: save the full "
                 "train state (plus epoch/batch position and metric "
                 "accumulators) every N optimizer steps under "
                 "$path-ckpt/mid; on restart training resumes mid-epoch "
                 "bit-exactly. 0 = per-epoch checkpoints only (the "
                 "reference protocol)",
        )
        tpu_group.add_argument(
            "--tpu-fault-at-step", type=int, default=0,
            help="fault injection for preemption testing: hard-exit the "
                 "process (status 42) once the global optimizer step "
                 "reaches N, without any cleanup — simulates a TPU-pod "
                 "preemption. 0 = disabled",
        )
        tpu_group.add_argument(
            "--tpu-watchdog-secs", type=float, default=0,
            help="hang detection: if no optimizer step completes for N "
                 "seconds, dump all thread stacks and exit 43 so a "
                 "supervisor restarts the job (exact resume with "
                 "--tpu-ckpt-every-steps). Armed after the first step of "
                 "the process (so initial compilation is exempt); size N "
                 "above the slowest legitimate step + eval compile. 0 = off",
        )
        tpu_group.add_argument(
            "--tpu-fault-hang-at-step", type=int, default=0,
            help="fault injection for watchdog testing: the host loop "
                 "sleeps forever once the global step reaches N. 0 = off",
        )
        tpu_group.add_argument(
            "--tpu-fault-signal-at-step", type=int, default=0,
            help="fault injection for graceful-preemption testing: the "
                 "process sends ITSELF a real SIGTERM at global step N "
                 "(cloud TPU preemption notice); with "
                 "--tpu-ckpt-every-steps the loop saves a mid-epoch "
                 "checkpoint and exits 143. 0 = off",
        )
        tpu_group.add_argument(
            "--tpu-fault-signal-process", type=int, default=-1,
            help="restrict --tpu-fault-signal-at-step to ONE process "
                 "index (multi-process preemption-consensus testing: a "
                 "single preempted host must drag the whole job through "
                 "the synchronized mid-checkpoint exit). -1 = every "
                 "process raises the signal",
        )
        tpu_group.add_argument(
            "--tpu-ema-decay", type=float, default=0.0,
            help="maintain an exponential moving average of the params "
                 "inside the train step (ema += (1-decay)*(p-ema), "
                 "initialized at the initial params); a training-time "
                 "alternative to last-N checkpoint averaging. 0 = off",
        )
        tpu_group.add_argument(
            "--tpu-decode-ema", type=ParseOption.str2bool, default="False",
            help="decode/serve with the EMA params recorded by "
                 "--tpu-ema-decay instead of the raw params",
        )
        tpu_group.add_argument(
            "--tpu-routing-kernel", default="auto",
            help="auto | xla | xla_pre | xla_flat | xla_factored | "
                 "wavefront | pallas : "
                 "SDR implementation (auto/xla = the measured optimum; the "
                 "others are benchmarked alternatives, see BENCH_NOTES.md)",
        )
        tpu_group.add_argument(
            "--tpu-dropout-kernel", default="xla",
            help="xla | pallas : dropout implementation for the CNN "
                 "family. pallas = one-pass fused mask via the TPU "
                 "hardware PRNG, regenerated (not saved) for the backward "
                 "pass — different random stream than the default "
                 "threefry masks, so it is opt-in (BENCH_NOTES.md)",
        )
        tpu_group.add_argument(
            "--tpu-mwer-nbest", type=int, default=4,
            help="n-best list size for the MWER fine-tune mode "
                 "(--train-is-mwer=True)",
        )
        tpu_group.add_argument(
            "--tpu-mwer-lam-ctc", type=float, default=0.1,
            help="CTC interpolation weight in the MWER loss",
        )
        tpu_group.add_argument(
            "--tpu-routing-bf16", type=ParseOption.str2bool, default="False",
            help="bf16 predictions/products inside the SDR routing body "
                 "(f32 squash/softmax tail). Measured on v5e: -8% step "
                 "time on the canonical WSJ shape, neutral on the "
                 "latency-bound TIMIT shape (BENCH_NOTES.md); small "
                 "numeric cost, so opt-in",
        )
        tpu_group.add_argument(
            "--tpu-attention-kernel", default="auto",
            help="auto | plain | blockwise | ring : STF attention. "
                 "'blockwise' is the flash-style O(T*block)-memory path "
                 "with the closed-form distance penalty; 'auto' switches "
                 "to it for long eval sequences (>= 2048 post-subsample "
                 "frames) and for training batches whose [B,H,T,T] "
                 "attention weights would exceed ~600MB/layer; 'ring' "
                 "shards the time axis over a device mesh "
                 "(sequence parallelism; programmatic use only — the CLI "
                 "trainers reject it since they build no time-axis mesh)",
        )
        tpu_group.add_argument(
            "--tpu-profile-dir", default=None,
            help="write a torch.profiler Chrome trace of the first trained "
                 "epoch here (chrome://tracing, Perfetto; every thread "
                 "where the torch build can record them)",
        )
        tpu_group.add_argument(
            "--tpu-fsdp", type=ParseOption.str2bool, default="False",
            help="fully-shard params + optimizer state over the data axis "
                 "(ZeRO-style); XLA inserts the gathers/scatters",
        )
        tpu_group.add_argument(
            "--tpu-serve-quant", default="none",
            choices=["none", "int8"],
            help="serving-time weight quantization (srf_tpu.serve): int8 "
                 "keeps only an int8 + per-channel-scale weight copy "
                 "resident and dequantizes inside the jitted forward "
                 "(4x less weight HBM traffic; training is untouched)",
        )
        tpu_group.add_argument(
            "--tpu-pipeline-stages", type=int, default=1,
            help="GPipe pipeline parallelism for the STF encoder stack: "
                 "split the N encoder blocks into this many stages over a "
                 "'pipe' mesh axis (trainer_tf only; 1 = off). Devices are "
                 "laid out (data x pipe); model-encoder-num must be "
                 "divisible by the stage count",
        )
        tpu_group.add_argument(
            "--tpu-pipeline-microbatch", type=int, default=4,
            help="microbatches streaming through the pipeline per step "
                 "(bubble fraction (S-1)/(M+S-1)); rounded down per bucket "
                 "shape to divide the batch",
        )
        tpu_group.add_argument(
            "--tpu-pipeline-remat", type=ParseOption.str2bool,
            default="False",
            help="rematerialize each pipeline stage in the backward pass "
                 "(trades recompute for activation memory)",
        )
        tpu_group.add_argument(
            "--tpu-seed", type=int, default=1234,
            help="PRNG seed (the reference leaves dropout unseeded)",
        )
        tpu_group.add_argument(
            "--device", default="cuda",
            help="cuda | cpu : where the PyTorch port runs. cuda raises "
                 "when no CUDA device exists; it never falls back to cpu",
        )
        tpu_group.add_argument(
            "--tpu-donate", type=ParseOption.str2bool, default="True",
            help="donate train-state buffers to the jitted step",
        )
        tpu_group.add_argument(
            "--tpu-grad-accum", type=int, default=1,
            help="gradient-accumulation microbatches per optimizer update "
                 "(same math as the full batch; ~N-fold lower activation "
                 "memory; indivisible bucket batches degrade to the "
                 "largest divisor)",
        )
        tpu_group.add_argument(
            "--tpu-decode-batch", type=int, default=1,
            help="decode-mode batch size (default 1 = the reference "
                 "protocol; >1 decodes whole batches per dispatch with "
                 "identical hypotheses — masking is exact — and falls "
                 "back to 1 when the utterance count is indivisible, "
                 "like the reference)",
        )
        tpu_group.add_argument(
            "--tpu-decode-pad-last", type=ParseOption.str2bool,
            default="False",
            help="keep --tpu-decode-batch on indivisible utterance counts "
                 "by padding the final batch with dummy utterances "
                 "(hypotheses identical; off = the reference's silent "
                 "fallback to batch 1, load_speech_data.py:127-145)",
        )
        tpu_group.add_argument(
            "--tpu-data-lazy", type=ParseOption.str2bool, default="False",
            help="out-of-core input pipeline: keep only a (shard, offset) "
                 "index + labels resident and read feature matrices back "
                 "per batch from the TFRecord shards (the reference "
                 "streams via tf.data, load_speech_data.py:43-46; our "
                 "default parses the split into host RAM). Use for "
                 "splits too large for host memory.",
        )
        tpu_group.add_argument(
            "--tpu-data-shard", default="example",
            choices=["example", "batch"],
            help="multi-process data sharding. 'example': each process "
                 "round-robins its own example shard and the bucket "
                 "schedule is lockstep-planned from allgathered lengths "
                 "(a bucket one process never fills starves globally). "
                 "'batch': every process scans the whole corpus and takes "
                 "its 1/n slice of each GLOBAL bucket batch — the "
                 "reference's tf.data AutoShardPolicy.DATA semantics "
                 "(trainer_sr.py:147-149); immune to skewed shard length "
                 "distributions and needs no collective, but requires "
                 "all processes to read all shard files (pair with "
                 "--tpu-data-lazy for large corpora).",
        )
        tpu_group.add_argument(
            "--tpu-import-src", default=None,
            help="reference TF checkpoint (prefix or directory) to convert "
                 "with tools/import_tf_ckpt",
        )
        tpu_group.add_argument(
            "--tpu-import-epoch", type=int, default=0,
            help="epoch number for the imported checkpoint (0 = parse from "
                 "the source's ckpt-N name)",
        )
        tpu_group.add_argument(
            "--tpu-export-dst", default=None,
            help="directory to write a REFERENCE-format TF checkpoint "
                 "(tools/export_tf_ckpt): the inverse of --tpu-import-src, "
                 "so models trained here migrate BACK to the reference",
        )
        tpu_group.add_argument(
            "--tpu-export-ref-repo", default=None,
            help="path to a checkout of the reference (sephiroce/srf) whose "
                 "model classes receive the exported weights; defaults to "
                 "$SRF_REF_REPO",
        )
        tpu_group.add_argument(
            "--tpu-specaug", type=ParseOption.str2bool, default="False",
            help="SpecAugment time/freq masking during training "
                 "(Park et al. 2019; no reference analog)",
        )
        tpu_group.add_argument(
            "--tpu-specaug-time-masks", type=int, default=2,
            help="SpecAugment: number of time masks per utterance",
        )
        tpu_group.add_argument(
            "--tpu-specaug-time-width", type=int, default=40,
            help="SpecAugment: max time-mask width (frames, capped at the "
                 "utterance length)",
        )
        tpu_group.add_argument(
            "--tpu-specaug-freq-masks", type=int, default=2,
            help="SpecAugment: number of frequency masks per utterance",
        )
        tpu_group.add_argument(
            "--tpu-specaug-freq-width", type=int, default=15,
            help="SpecAugment: max frequency-mask width (feature dims)",
        )
        tpu_group.add_argument(
            "--tpu-decode-impl", default="device",
            help="device (jittable beam scan; ~2x the host beam's RTF since"
                 " the sort-free rewrite) | host (C++/python prefix beam)"
                 " | greedy",
        )
        tpu_group.add_argument(
            "--tpu-lm-path", default=None,
            help="shallow fusion: .npz n-gram LM (tools/train_ngram_lm) "
                 "fused into every beam decode path as "
                 "ctc + weight*logP_lm + bonus*len; greedy ignores it",
        )
        tpu_group.add_argument(
            "--tpu-lm-weight", type=float, default=0.3,
            help="shallow-fusion LM weight (lambda)",
        )
        tpu_group.add_argument(
            "--tpu-lm-bonus", type=float, default=0.0,
            help="shallow-fusion per-token insertion bonus (counters the "
                 "LM's bias toward shorter hypotheses)",
        )
        return parser
