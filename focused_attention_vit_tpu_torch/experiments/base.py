"""Shared experiment machinery (port of
``focused_attention_vit_tpu/experiments/base.py``).

Every experiment follows the reference five-method protocol
setup -> train -> evaluate -> save_results -> run and shares:

* the data loading path (CIFAR-10/100 with ``subset_size`` debugging mode),
* a memory probe on a sample batch before training, at ``epochs // 2`` (with
  a backward) and after,
* per-epoch progress lines and a one-row CSV in ``results_dir``, written
  with the standard ``csv`` module.

The port runs the eight experiments of the JAX package: E1
``traditional``, E2 ``sppp``, the pretrained fine-tunes E3
``traditional_pretrained``, E4 ``sppp_pretrained``, E5 ``mhla_pretrained``
and E6 ``sppp_mhla_pretrained``, which load their weights in the
:meth:`ExperimentBase.build_params` hook, and the cross-attention suites E7
``cross_attention`` and E8 ``multihead_cross_attention``
(:mod:`.attention`). The experiment runs on the card: ``device=None`` means
CUDA, and ``setup`` raises without it; ``device="cpu"`` asks for the CPU.

With ``checkpoint_dir`` the run saves its :class:`~..train.TrainState`
after every epoch (asynchronously unless ``sync_checkpoint``), resumes from
the latest checkpoint there, and under SIGTERM stops at a batch boundary,
saves and sets ``preempted`` (the CLI then exits with 143), as JAX's does.
``profile_dir`` writes a ``torch.profiler`` trace of the training loop
(:mod:`..utils.profiling`); ``remat`` and ``remat_policy`` rematerialise the
blocks of the models that take them (the dense and MHLA ViTs), and
``mu_dtype="bfloat16"`` keeps AdamW's first moment in bf16, as in JAX;
``scan_layers`` is accepted and a no-op (the model says so on stderr).
``dataset="imagenet"`` reads ``<data_dir>/imagenet`` (:mod:`..data.imagenet`).

``num_devices`` (-1: every device), ``tp``, ``sp`` and ``pp`` build a
``(data, model[, seq][, stage])`` mesh over the ranks of the process group
(:meth:`ExperimentBase._build_mesh`; ``cli.main`` starts the ranks, or
``torchrun`` does). ``setup`` gives the model the ``seq`` dimension
(sequence parallelism: MHLA-family models only) and the ``stage`` dimension
(pipeline parallelism: the models with ``pp_mesh``, under
``scan_layers``), as JAX clones its model with ``sp_mesh`` and ``pp_mesh``,
and shards the state over the mesh (:func:`~..parallel.shard_state`: DDP,
or FSDP2 with ``fsdp``, tensor parallelism at ``tp > 1``, each stage's
blocks). Rank 0 alone writes the CSV, the confusion matrix and the
checkpoints, which hold the full state.
"""

from __future__ import annotations

import csv
import os
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from focused_attention_vit_tpu_torch.data.datasets import load_dataset
from focused_attention_vit_tpu_torch.data.pipeline import prepare_eval_batch
from focused_attention_vit_tpu_torch.train import (
    create_train_state,
    evaluate,
    evaluate_detailed,
    make_adamw,
    make_eval_step,
    make_lr_schedule,
    make_train_step,
    train_and_evaluate,
)
from focused_attention_vit_tpu_torch.utils import profiling
from focused_attention_vit_tpu_torch.utils.metrics import (
    calculate_model_size,
    calculate_vit_complexity,
    measure_memory_usage,
)



def is_rank_zero() -> bool:
    """True outside a process group and on its rank 0: the process that
    writes results and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclass
class ExperimentBase:
    """Config and pipeline shared by all experiments. Field names mirror
    the reference constructors, so CLI flags map straight through."""

    img_size: int = 224
    patch_size: int = 4
    in_channels: int = 3
    num_classes: int = 10
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    dropout: float = 0.1
    attn_dropout: float = 0.0
    embed_dropout: float = 0.0
    batch_size: int = 128
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    epochs: int = 50
    device: Optional[str] = None  # None: the card; "cpu" for the CPU
    data_dir: str = "./data"
    results_dir: str = "./results"
    subset_size: Optional[int] = None
    dataset: str = "cifar10"
    seed: int = 42
    checkpoint_dir: Optional[str] = None  # per-epoch TrainState saves
    sync_checkpoint: bool = False  # block on each save (default: async)
    profile_dir: Optional[str] = None  # torch.profiler trace of training
    detailed_metrics: bool = True  # AUC + confusion matrix at evaluate()
    compute_dtype: str = "float32"  # 'bfloat16': autocast over f32 params
    remat: bool = False  # recompute each block's activations in backward
    # What the per-block remat saves (MHLA models): None/'full' nothing,
    # 'band_weights' the band's weights (models/layers.resolve_remat_policy).
    remat_policy: Optional[str] = None
    # LR schedule over the whole run (reference protocol = constant LR;
    # these are opt-in extensions).
    lr_schedule: str = "constant"  # 'constant' | 'cosine'
    warmup_epochs: float = 0.0  # linear warmup, in (fractional) epochs
    grad_clip_norm: Optional[float] = None  # global-norm gradient clipping
    mu_dtype: str = "float32"  # 'bfloat16': AdamW's first moment in bf16
    scan_layers: bool = False  # accepted; a no-op in the port
    num_devices: Optional[int] = None  # ranks of the mesh; -1: all devices
    fsdp: bool = False  # FSDP2 over the mesh's data dimension
    tp: int = 1  # tensor-parallel size (the mesh's model dimension)
    sp: int = 1  # sequence-parallel size (the mesh's seq dimension)
    pp: int = 1  # pipeline-parallel size (the mesh's stage dimension)
    # Gradient-accumulation chunk of the train step. None = auto (the
    # class's ``auto_microbatch``); 0 disables. Accumulation does not
    # change the batch math: it trades speed against live activations.
    microbatch: Optional[int] = None

    # Set by train() when SIGTERM stopped a run with a checkpoint_dir: the
    # state is saved, run() skips evaluation, the CLI exits with 143.
    preempted: bool = field(default=False, init=False)

    # --- subclass hooks -----------------------------------------------------
    model_display_name: str = "Traditional ViT"
    csv_filename: str = "exp1_traditional.csv"
    # Auto microbatch, used when ``microbatch`` is None. Off: no chunk size
    # has been measured to win on the card (PERF.md has the timings). The
    # JAX package's 16 is a TPU measurement and is not carried over.
    auto_microbatch: Optional[int] = None

    # The (data, model[, seq][, stage]) DeviceMesh, set by setup() (None: one
    # device).
    mesh = None

    @property
    def torch_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)

    def build_model(self) -> torch.nn.Module:
        """The model, on ``self.torch_device``, its weights drawn from a
        generator seeded with ``self.seed``."""
        raise NotImplementedError

    def _slic_connectivity(self):
        """The ``--slic_connectivity`` string as
        :func:`~..ops.slic.slic_segment`'s ``enforce_connectivity``."""
        v = getattr(self, "slic_connectivity", "auto")
        if isinstance(v, str):
            v = v.lower()
            if v in ("auto", "host"):
                return v
            if v in ("on", "true", "1"):
                return True
            if v in ("off", "false", "0"):
                return False
            raise ValueError(
                f"slic_connectivity must be auto/on/off/host, got {v!r}")
        return bool(v)

    def build_params(self, model: torch.nn.Module) -> None:
        """Called between :meth:`build_model` and the train state; may load
        weights into ``model`` in place. Default: keep the random init
        (pretrained experiments override)."""

    def _steps_per_epoch(self) -> int:
        n = len(self.data["train_images"]) if getattr(self, "data", None) else 0
        return max(n // self.batch_size, 1)

    def lr_for(self, base_lr: float):
        """base LR -> float (reference protocol) or schedule (extension)."""
        spe = self._steps_per_epoch()
        return make_lr_schedule(
            base_lr,
            kind=self.lr_schedule,
            total_steps=self.epochs * spe,
            warmup_steps=int(round(self.warmup_epochs * spe)),
        )

    def _mu_dtype(self):
        if self.mu_dtype in (None, "float32", "f32"):
            return None
        if self.mu_dtype in ("bfloat16", "bf16"):
            return torch.bfloat16
        raise ValueError(
            f"--mu_dtype must be 'float32' or 'bfloat16', got "
            f"{self.mu_dtype!r}"
        )

    def build_optimizer(self):
        return make_adamw(
            self.lr_for(self.learning_rate),
            self.weight_decay,
            grad_clip_norm=self.grad_clip_norm,
            mu_dtype=self._mu_dtype(),
        )

    def theoretical_metrics(self) -> Dict[str, Any]:
        return calculate_vit_complexity(
            img_size=self.img_size,
            patch_size=self.patch_size,
            embed_dim=self.embed_dim,
            depth=self.depth,
            num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio,
            in_channels=self.in_channels,
        )

    def _check_remat_flags(self) -> None:
        """JAX's rules: ``remat_policy`` only under ``remat``, and each of
        ``scan_layers``, ``remat`` and a ``remat_policy`` other than
        ``'full'`` only on a model that has the option."""
        if self.remat_policy and not self.remat:
            raise ValueError(
                "--remat_policy only applies under --remat (it selects "
                "what the per-block checkpointing saves)"
            )
        for flag in ("scan_layers", "remat", "remat_policy"):
            # 'full' is the explicit spelling of what --remat alone does,
            # so it is valid on any remat-capable model.
            if flag == "remat_policy" and self.remat_policy in (None, "full"):
                continue
            if getattr(self, flag, False) and not hasattr(self.model, flag):
                raise ValueError(
                    f"--{flag} is not supported by "
                    f"{type(self.model).__name__} (token-reduced SPPP "
                    f"models have tiny per-block state; the flag targets "
                    f"the long-sequence transformer stacks)"
                )

    def _parallel_model(self) -> None:
        """Give the model the mesh's ``seq`` and ``stage`` dimensions, with
        JAX's errors for a model without the option (JAX
        ``experiments/base.py`` :281-305)."""
        names = () if self.mesh is None else self.mesh.mesh_dim_names
        if "seq" in names:
            if not hasattr(self.model, "sp_mesh"):
                raise ValueError(
                    f"--sp requires an MHLA-family model; "
                    f"{type(self.model).__name__} has no sequence-parallel "
                    f"support (dense attention is not window-local)"
                )
            self.model.sp_mesh = self.mesh
            self.model.enable_sequence_parallel(self.mesh, "seq")
        if "stage" in names:
            if not hasattr(self.model, "pp_mesh"):
                raise ValueError(
                    f"--pp not supported by {type(self.model).__name__}"
                )
            if not getattr(self.model, "scan_layers", False):
                raise ValueError(
                    "--pp requires the scan-form block stack: pass "
                    "--scan_layers (random-init experiments; pretrained "
                    "experiments build loop-form params — convert with "
                    "layers.stack_block_params)"
                )
            self.model.pp_mesh = self.mesh
            self.model.enable_pipeline_parallel(self.mesh, "stage")

    def _resolve_device(self) -> torch.device:
        """The card (each rank of a process group its own: ``LOCAL_RANK``,
        else the rank modulo the card count), or the CPU when asked."""
        device = torch.device("cuda" if self.device is None else self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the experiment runs on a CUDA device and none is "
                "available; pass device=\"cpu\" (--device cpu) to run on "
                "the CPU"
            )
        if (device.type == "cuda" and device.index is None
                and dist.is_initialized()):
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
            torch.cuda.set_device(device)
        return device

    def _build_mesh(self):
        """The mesh when multi-device training is asked for
        (``num_devices``, ``tp``, ``sp``, ``pp``), as JAX's
        ``_build_mesh``: one device with ``tp``, ``sp`` and ``pp`` at most 1
        is no mesh, and the batch must split over the data dimension. The
        ranks must already form the process group."""
        one = self.tp <= 1 and self.sp <= 1 and self.pp <= 1
        if not self.num_devices and one:
            return None
        n = self.num_devices
        if n is None or n <= 0:
            if dist.is_initialized():
                n = dist.get_world_size()
            elif self.torch_device.type == "cuda":
                n = torch.cuda.device_count()
            else:
                n = 1
        if n == 1 and one:
            return None
        if n % (self.tp * self.sp * self.pp):
            raise ValueError(
                f"tp={self.tp} must divide device count {n}"
                if self.sp <= 1 and self.pp <= 1 else
                f"tp={self.tp} * sp={self.sp} * pp={self.pp} must divide "
                f"device count {n}")
        if not dist.is_initialized():
            raise RuntimeError(
                f"--num_devices {n} / --tp {self.tp} / --sp {self.sp} / "
                f"--pp {self.pp}: the ranks are not "
                f"started; run through cli.main (which starts them) or "
                f"torchrun")
        from focused_attention_vit_tpu_torch.parallel import make_mesh

        mesh = make_mesh(n, tp=self.tp, sp=self.sp, pp=self.pp)
        dp = mesh.size(0)
        if self.batch_size % dp:
            raise ValueError(
                f"batch_size={self.batch_size} must be divisible by the "
                f"data-parallel axis size {dp}")
        if is_rank_zero():
            print(f"Training on a {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                  f" device mesh ({mesh.size()} devices)")
        return mesh

    def _load_data(self) -> Dict[str, Any]:
        if self.dataset == "imagenet":
            from focused_attention_vit_tpu_torch.data.imagenet import (
                load_imagenet_subset,
            )

            return load_imagenet_subset(
                data_dir=os.path.join(self.data_dir, "imagenet"),
                subset_size=self.subset_size, seed=self.seed)
        return load_dataset(self.dataset, data_dir=self.data_dir,
                            subset_size=self.subset_size, seed=self.seed)

    # --- pipeline -----------------------------------------------------------
    def setup(self):
        self._mu_dtype()  # a bad --mu_dtype fails before anything runs
        self.torch_device = self._resolve_device()
        self.mesh = self._build_mesh()
        if self.fsdp and self.mesh is None:
            raise ValueError(
                "--fsdp requires a device mesh (--num_devices/--tp/...): "
                "parameter sharding needs a 'data' axis to shard over")
        os.makedirs(self.results_dir, exist_ok=True)
        self.data = self._load_data()
        # The dataset is the authority on class count: a head built for the
        # config default would train on out-of-range labels and feed
        # mis-shaped probabilities to the detailed metrics.
        data_classes = self.data.get("num_classes")
        if data_classes and data_classes != self.num_classes:
            print(
                f"num_classes: {self.dataset} provides {data_classes} "
                f"classes (config said {self.num_classes}) — using "
                f"{data_classes}"
            )
            self.num_classes = int(data_classes)
        self.model = self.build_model()
        self._check_remat_flags()
        self._parallel_model()
        self.build_params(self.model)
        self.state = create_train_state(self.model, self.build_optimizer(),
                                        device=self.torch_device)

        self.metrics: Dict[str, Any] = {}
        self.metrics["theoretical"] = self.theoretical_metrics()
        self.metrics["model_size"] = calculate_model_size(self.model)

        if self.mesh is not None:
            from focused_attention_vit_tpu_torch.parallel import shard_state

            self.state = shard_state(self.state, self.mesh, fsdp=self.fsdp)
        self.train_step = make_train_step(
            self.img_size,
            compute_dtype=self.torch_dtype,
            microbatch=self._effective_microbatch(),
            mesh=self.mesh,
        )
        self.eval_step = make_eval_step(
            self.img_size, compute_dtype=self.torch_dtype, mesh=self.mesh
        )

    def _auto_microbatch_value(self) -> Optional[int]:
        """Geometry-aware auto-microbatch hook (subclasses override)."""
        return self.auto_microbatch

    def _effective_microbatch(self) -> Optional[int]:
        mb = self.microbatch
        if mb == 0:
            return None
        if mb is not None and mb < 0:
            raise ValueError(f"--microbatch must be positive (got {mb})")
        if mb is not None and self.mesh is not None:
            # Each accumulation chunk is itself split over the data ranks.
            dp = self.mesh.size(0)
            if mb % dp:
                raise ValueError(
                    f"--microbatch {mb} must be a multiple of the "
                    f"data-parallel axis size {dp} (each accumulation "
                    f"chunk is itself batch-sharded over 'data')"
                )
        if mb is not None:
            # Explicit flag: refuse values the step could not honor instead
            # of silently running monolithic (a benchmark or an
            # out-of-memory decision built on the flag must not be
            # invalidated quietly).
            if not (self.batch_size > mb and self.batch_size % mb == 0):
                raise ValueError(
                    f"--microbatch {mb} must be a proper divisor of "
                    f"--batch_size {self.batch_size} (or 0 to disable)"
                )
            return mb
        # Auto: one device only (a mesh already shrinks the per-device
        # batch). Auto values that don't divide the batch fall back to
        # monolithic silently: auto is a heuristic, not a request.
        if self.mesh is not None:
            return None
        mb = self._auto_microbatch_value()
        if not mb:
            return None
        return mb if (self.batch_size > mb and self.batch_size % mb == 0) else None

    def _sample_batch(self) -> torch.Tensor:
        imgs = self.data["train_images"][: min(8, len(self.data["train_images"]))]
        return prepare_eval_batch(
            torch.from_numpy(np.ascontiguousarray(imgs)).to(self.torch_device),
            self.img_size)

    def _memory_probe(self, backward: bool) -> Dict[str, float]:
        """One eval-mode pass (and backward) of the model on the sample
        batch, in the compute dtype, on every rank of a mesh. Under FSDP
        the probe runs the forward only: its parameters' gradients come
        from FSDP's reduce-scatter, not from autograd; so it does under
        pipeline parallelism, whose blocks' gradients the schedule's own
        backward adds into ``.grad``. A probe that fails is a fault to see:
        nothing is caught."""
        backward = backward and not (self.mesh is not None and (
            self.fsdp or "stage" in self.mesh.mesh_dim_names))
        model = self.model
        was_training = model.training
        model.eval()
        params = [p for p in model.parameters() if p.requires_grad]

        def apply(x, _params):
            with torch.autocast(self.torch_device.type, dtype=torch.bfloat16,
                                enabled=self.torch_dtype == torch.bfloat16):
                return model(x)

        try:
            return measure_memory_usage(apply, self._sample_batch(), params,
                                        backward=backward)
        finally:
            model.train(was_training)

    def train(self):
        memory_usage = [self._memory_probe(backward=False)]
        half = self.epochs // 2

        ckpt_mngr = None
        start_epoch = 0
        if self.checkpoint_dir:
            from focused_attention_vit_tpu_torch.train.checkpoint import (
                CheckpointManager,
            )

            ckpt_mngr = CheckpointManager(
                self.checkpoint_dir, async_save=not self.sync_checkpoint)
            latest = ckpt_mngr.latest_step()
            if latest is not None:
                ckpt_mngr.restore(self.state)
                start_epoch = latest
                print(f"Resumed from checkpoint epoch {latest}")

        def epoch_cb(epoch, state):
            # ``epoch`` is local to this (possibly resumed) segment; the
            # bookkeeping uses the global epoch, so that checkpoints continue
            # the step numbering and the mid-run probe fires at the run's
            # midpoint.
            g = start_epoch + epoch
            if g == half:
                self.state = state
                memory_usage.append(self._memory_probe(backward=True))
            if ckpt_mngr is not None:
                ckpt_mngr.save(g + 1, state)

        # SIGTERM -> checkpoint -> exit 143 needs somewhere to checkpoint;
        # without a manager the default signal disposition stays.
        interrupt = should_stop = None
        if ckpt_mngr is not None:
            from focused_attention_vit_tpu_torch.train.resilience import (
                GracefulShutdown,
            )

            interrupt = should_stop = GracefulShutdown()
            if self.state.layout is not None:
                # Every rank stops at the same batch.
                def should_stop():
                    return self.state.layout.agree(interrupt())

        with profiling.trace(self.profile_dir), (interrupt or nullcontext()):
            results = train_and_evaluate(
                self.state,
                self.train_step,
                self.eval_step,
                self.data,
                epochs=max(0, self.epochs - start_epoch),
                batch_size=self.batch_size,
                seed=self.seed,
                epoch_offset=start_epoch,
                epoch_callback=epoch_cb,
                should_stop=should_stop,
            )
        self.preempted = bool(results.pop("interrupted", False))
        mid_epoch = bool(results.pop("interrupted_mid_epoch", False))
        if self.preempted:
            g_done = start_epoch + len(results["train_losses"])
            if mid_epoch:
                # The partial epoch counts as complete (its remaining
                # batches are skipped on resume): trained work is never
                # lost, and the resumed run still totals ``epochs``.
                g_done += 1
                ckpt_mngr.save(g_done, results["state"])
            print(
                f"Preempted (SIGTERM): training stopped at epoch {g_done}"
                + (" (checkpoint committed); rerun the same command to"
                   " resume" if g_done > 0
                   else " (before any training; a rerun starts fresh)")
            )
        if ckpt_mngr is not None:
            ckpt_mngr.close()
        self.state = results.pop("state", self.state)
        if start_epoch >= self.epochs and self.epochs > 0:
            # A fully trained checkpoint with nothing left to train: the CSV's
            # final_val columns describe the restored model.
            print(
                f"Checkpoint already at epoch {start_epoch} >= "
                f"epochs={self.epochs}; skipping training and evaluating "
                f"the restored model"
            )
            val = evaluate(
                self.eval_step, self.state,
                self.data["test_images"], self.data["test_labels"],
                self.batch_size,
            )
            results["final_val_acc"] = val["acc"]
            results["final_val_loss"] = val["loss"]
        memory_usage.append(self._memory_probe(backward=False))
        results["memory_usage"] = memory_usage
        self.metrics["training"] = results

    def evaluate(self):
        ev = evaluate(
            self.eval_step,
            self.state,
            self.data["test_images"],
            self.data["test_labels"],
            self.batch_size,
        )
        self.metrics["evaluation"] = {
            "test_loss": ev["loss"],
            "test_acc": ev["acc"],
            "avg_inference_time": ev["avg_batch_time"],
            "avg_inference_time_per_image": ev["avg_image_time"],
        }
        print(
            f"Test Loss: {ev['loss']:.4f} | Test Acc: {ev['acc']:.2f}% | "
            f"Avg Inference Time per Batch: {ev['avg_batch_time']:.4f}s | "
            f"Avg Inference Time per Image: {ev['avg_image_time']:.4f}s"
        )

        if self.detailed_metrics:
            det = evaluate_detailed(
                self.state,
                self.data["test_images"],
                self.data["test_labels"],
                self.batch_size,
                self.img_size,
                self.data["num_classes"],
                mesh=self.mesh,
            )
            self.metrics["evaluation_detailed"] = det
            if is_rank_zero():
                np.save(
                    os.path.join(
                        self.results_dir,
                        self.csv_filename.replace(".csv", "_confusion.npy"),
                    ),
                    det["confusion_matrix"],
                )
            print(
                f"AUC (macro OvR): {det['auc_macro_ovr']:.4f} | "
                f"confusion matrix saved"
            )

    # --- results ------------------------------------------------------------
    def results_row(self) -> Dict[str, Any]:
        """One-row results dict; the reference exp1 schema. Subclasses
        extend."""
        th = self.metrics["theoretical"]
        tr = self.metrics["training"]
        ev = self.metrics["evaluation"]
        peak = max(
            (
                m.get("gpu_memory_peak_mb", 0.0)
                for m in tr["memory_usage"]
            ),
            default=0.0,
        )
        return {
            "model": self.model_display_name,
            "img_size": self.img_size,
            "patch_size": self.patch_size,
            "embed_dim": self.embed_dim,
            "depth": self.depth,
            "num_heads": self.num_heads,
            "parameters": th["parameters"],
            "flops": th["flops"],
            "time_complexity": th["time_complexity"],
            "space_complexity_mb": th["space_complexity_mb"],
            "model_size_mb": self.metrics["model_size"]["size_mb"],
            "avg_epoch_time": tr["avg_epoch_time"],
            "total_training_time": tr["total_training_time"],
            "final_val_acc": tr["final_val_acc"],
            "final_val_loss": tr["final_val_loss"],
            "test_acc": ev["test_acc"],
            "test_loss": ev["test_loss"],
            "avg_inference_time_per_image": ev["avg_inference_time_per_image"],
            "peak_gpu_memory_mb": peak,
        }

    def save_results(self):
        csv_path = os.path.join(self.results_dir, self.csv_filename)
        row = self.results_row()
        if not is_rank_zero():
            return csv_path
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row))
            writer.writeheader()
            writer.writerow(row)
        print(f"Results saved to {csv_path}")
        return csv_path

    def run(self):
        print("Setting up experiment...")
        self.setup()
        print("Starting training...")
        self.train()
        if self.preempted:
            print(
                "Experiment preempted — skipping evaluation/results "
                "(resume with the same command)."
            )
            return self.metrics
        print("Evaluating model...")
        self.evaluate()
        print("Saving results...")
        self.save_results()
        print("Experiment completed!")
        return self.metrics
