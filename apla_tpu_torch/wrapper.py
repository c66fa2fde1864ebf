"""DefaultWrapper: builds data, model, optimizer, schedule, loss and metric
class from a recipe's params; the trainer consumes them.

Counterpart of `apla_tpu/wrapper.py:31-334`, without the mesh: the port
trains on one device, `system_params.device` (default "cuda": the first
card; without one the wrapper raises unless the caller asked for "cpu").
`build_vit_config` / `build_apla_config` are plain
functions of the merged params dict (what `utils.config.load_merged_params`
returns, or an equivalent plain dict).  TPU-only knobs (`fused_vmem_mb`,
`remat`) have no meaning here and are not read.

`init_model` follows the JAX order (`apla_tpu/wrapper.py:269-287`): the
seeded model, then `model_params.pretrained` (a local DINOv2 `.pth`,
`utils.pretrained.maybe_load_pretrained_backbone`), then
`transfer_learning_params.pretrained_path` (a checkpoint directory of the
port, `train.checkpoint.transfer_into`), then `quantize_frozen` (W8A8: the
frozen qkv / fc1 / fc2 kernels in int8, before the optimizer is built).
The SSL wrappers take the first two at the same points and refuse
`quantize_frozen`, which the JAX SSL wrappers never read.  What the port
does not have yet raises `NotImplementedError` naming its ROADMAP item: the
mesh and parallel knobs and multi-label data.
"""

from __future__ import annotations

from copy import deepcopy

import torch

from .apla.core import AplaConfig
from .data import datasets as datasets_mod
from .data.loader import DataLoader
from .models.classifier import init_classifier
from .models.vit import VIT_BUILDERS, ViTConfig
from .ops.quant import quantize_frozen_backbone
from .train.checkpoint import transfer_into
from .train.losses import get_criterion
from .train.metrics import ClassificationMetrics
from .train.optim import build_optimizer
from .train.schedules import LRScheduler
from .train.train_state import TrainState
from .utils.config import EDict
from .utils.pretrained import maybe_load_pretrained_backbone

_ROADMAP_PARALLEL = "ROADMAP queue A: parallel modes"


def build_vit_config(params: dict) -> ViTConfig:
    mp = params["model_params"]
    tp = mp.get("transformers_params") or {}
    builder = VIT_BUILDERS[mp["backbone_type"]]
    block_conf = tp.get("block_conf") or {}
    img_size = tp.get("img_size", [224])
    img_size = img_size[0] if isinstance(img_size, (list, tuple)) else img_size
    use_mp = (params.get("training_params") or {}).get(
        "use_mixed_precision", True)
    return builder(
        img_size=int(img_size),
        patch_size=int(tp.get("patch_size", 16)),
        drop_rate=float(tp.get("drop_rate", 0.0)),
        attn_drop_rate=float(tp.get("attn_drop_rate", 0.0)),
        drop_path_rate=float(tp.get("drop_path_rate", 0.0)),
        has_layerscale=bool(block_conf.get("has_layerscale", False)),
        layerscale_init=float(block_conf.get("layerscale_init_values", 1e-5)),
        num_register_tokens=int(tp.get("num_register_tokens", 0)),
        compute_dtype=torch.bfloat16 if use_mp else torch.float32,
        use_flash=bool(tp.get("is_memory_efficient", False)),
        use_fused_apla=bool(tp.get("use_fused_apla", False)),
        gelu_tanh=bool(tp.get("gelu_tanh", False)),
    )


def build_apla_config(params: dict) -> AplaConfig | None:
    adaptation = params["model_params"].get("adaptation")
    if not adaptation or adaptation.get("mode") != "apla":
        return None
    p = adaptation.get("params") or {}
    return AplaConfig(partial_size=p.get("partial_size", 32),
                      inds_path=p.get("inds_path"),
                      seed=int(p.get("seed", 0)))


def resolve_device(name) -> torch.device:
    """The entry points' device: `name` (default "cuda").  A CUDA device
    that is not there raises: a run never moves to the CPU unasked."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch sees no CUDA card; "
            "set system_params.device to 'cpu' (--device cpu) to run on the "
            "CPU")
    return device


# Float32 matrix products and convolutions in IEEE f32, never TF32: the
# setting chip_smoke.py's card checks run (and the JAX reference's on the
# CPU).  PyTorch's default runs f32 convolutions through cuDNN in TF32;
# PERF.md (§6) has the f32 detector's readings with it on and off.
ALLOW_TF32 = False


def set_float32_precision(allow_tf32: bool = ALLOW_TF32) -> None:
    """Set both TF32 flags (matmul and cuDNN) to `allow_tf32`; the CLI
    entry points call it before they build anything."""
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32


class DefaultWrapper:
    is_supervised = True

    def __init__(self, parameters: dict):
        parameters = EDict(deepcopy(dict(parameters)))
        parameters = self.update_augmentation_strategy(parameters)
        self.parameters = parameters
        self.dataset_params = parameters.dataset_params
        self.dataloader_params = parameters.dataloader_params
        self.model_params = parameters.model_params
        self.optimization_params = parameters.optimization_params
        self.training_params = parameters.training_params
        self.system_params = parameters.get("system_params") or EDict()
        self.transfer_learning_params = parameters.get(
            "transfer_learning_params") or EDict()
        self.device = resolve_device(self.system_params.get("device"))
        self._check_unported()

    # overridden by the SSL wrappers (the multi-crop strategy)
    def update_augmentation_strategy(self, parameters):
        return parameters

    def _check_unported(self):
        sp, mp = self.system_params, self.model_params
        for knob in ("tensor_parallel", "pipeline_parallel", "n_devices"):
            if int(sp.get(knob) or 1) > 1:
                raise NotImplementedError(
                    f"system_params.{knob}={sp[knob]} ({_ROADMAP_PARALLEL})")
        if sp.get("sequence_parallel"):
            raise NotImplementedError(
                f"system_params.sequence_parallel ({_ROADMAP_PARALLEL})")
        if sp.get("param_sharding") not in (None, "replicated"):
            raise NotImplementedError(
                f"param_sharding {sp['param_sharding']!r} "
                f"({_ROADMAP_PARALLEL})")
        if mp.get("quantize_frozen") and not self.is_supervised:
            raise NotImplementedError(
                "model_params.quantize_frozen: W8A8 training runs in the "
                "supervised wrapper (DefaultWrapper) only; the SSL wrappers "
                "do not read it, in the JAX package either (ROADMAP A 2)")

    # ------------------------------------------------------------------ #
    def instantiate(self, seed: int = 0):
        self.dataloaders = self.init_dataloaders()
        trainset = self.dataloaders.trainloader.dataset
        self.task = trainset.task
        self.is_multiclass = trainset.is_multiclass
        self.model_params.n_classes = trainset.n_classes
        self.model_params.knn_nhood = trainset.knn_nhood
        self.model_params.target_metric = trainset.target_metric
        self.init_model(seed)
        self.init_optimization()
        self.criterion = get_criterion(self.task, self.is_multiclass)
        self.metric_class = ClassificationMetrics

    # ------------------------------------------------------------------ #
    def init_dataloaders(self) -> EDict:
        DataSet = datasets_mod.get_dataset_class(self.dataset_params.dataset)
        trainset = DataSet(self.dataset_params, mode="train")
        valset = DataSet(self.dataset_params, mode="val")
        testset = DataSet(self.dataset_params, mode="test")

        # kNN feature bank: the training images through the eval transforms
        fbank_set = None
        if self.training_params.get("knn_eval") or not self.is_supervised:
            fbank_set = DataSet(self.dataset_params, mode="train")
            fbank_set.train_transforms = fbank_set.val_transforms

        # device-side augmentation: the host ships resized uint8 images; the
        # geometric/photometric tail runs on the device inside the step
        self.device_aug_cfg = None
        if self.dataset_params.get("device_augment") and self.is_supervised:
            from .data.device_augs import DeviceAugConfig
            tt = self.dataset_params.get("train_transforms", {})
            rrc = tt.get("RandomResizedCrop", {})
            cj = tt.get("ColorJitter", {})
            rs = tt.get("Resize", {})
            flip = tt.get("HorizontalFlip", {})
            gray = tt.get("RandomGrayscale", {})
            trainset.raw_mode = True
            trainset.raw_size = int(rs.get("height", 256)) \
                if rs.get("apply") else 256
            self.device_aug_cfg = DeviceAugConfig(
                out_size=int(rrc.get("size", 224)),
                crop_scale=tuple(rrc.get("scale", (0.8, 1.2))),
                hflip_p=float(flip.get("p", 0.5)) if flip.get("apply")
                else 0.0,
                jitter_p=float(cj.get("p", 0.8) if cj.get("apply") else 0.0),
                brightness=float(cj.get("brightness", 0.2)),
                contrast=float(cj.get("contrast", 0.2)),
                saturation=float(cj.get("saturation", 0.1)),
                hue=float(cj.get("hue", 0.0)),
                grayscale_p=float(gray.get("p", 0.0)) if gray.get("apply")
                else 0.0,
                mean=tuple(trainset.mean), std=tuple(trainset.std))

        # mixup/cutmix collate
        train_collate = None
        tt = self.dataset_params.get("train_transforms")
        if isinstance(tt, dict) and tt.get("advanced_aug"):
            from .data.mixup import AdvancedAugCollate
            aug_params = dict(tt.get("advanced_aug_params", {}))
            aug_params["num_classes"] = trainset.n_classes
            train_collate = AdvancedAugCollate(aug_params)

        pin = self.device.type == "cuda"
        trainloader = DataLoader(trainset, collate_fn=train_collate,
                                 pin_memory=pin,
                                 **self.dataloader_params["trainloader"])
        testloader = DataLoader(testset, pin_memory=pin,
                                **self.dataloader_params["testloader"])
        valloader = DataLoader(valset, pin_memory=pin,
                               **self.dataloader_params["valloader"]) \
            if len(valset) > 0 else testloader
        fbank_loader = None
        if fbank_set is not None:
            fb_params = dict(self.dataloader_params["valloader"])
            fb_params["shuffle"] = False
            fbank_loader = DataLoader(fbank_set, pin_memory=pin, **fb_params)
        return EDict(trainloader=trainloader, valloader=valloader,
                     testloader=testloader, fbank_loader=fbank_loader)

    def init_model(self, seed: int = 0):
        self.vit_cfg = build_vit_config(self.parameters)
        self.model = init_classifier(
            self.vit_cfg, int(self.model_params.n_classes),
            apla_cfg=build_apla_config(self.parameters),
            freeze_backbone=bool(self.model_params.get("freeze_backbone",
                                                       False)),
            generator=torch.Generator().manual_seed(seed), device=self.device)
        self.load_weights("supervised")
        # W8A8: the frozen large kernels in int8 before the optimizer sees
        # the model (a full fine-tune has no frozen backbone to quantize)
        if self.model_params.get("quantize_frozen") and any(
                not p.requires_grad for p in self.model.backbone.parameters()):
            quantize_frozen_backbone(self.model)
            print("Quantized frozen backbone kernels to int8 (W8A8)")
        n_train = sum(p.numel() for p in self.model.parameters()
                      if p.requires_grad)
        n_total = sum(p.numel() for p in self.model.parameters()) \
            + sum(b.numel() for b in self.model.buffers())
        print(f"Model: {self.model_params.backbone_type} "
              f"trainable={n_train:,} / total={n_total:,} "
              f"({100.0 * n_train / max(n_total, 1):.2f}%)")

    def load_weights(self, where: str) -> None:
        """The recipe's weights into `self.model` in the JAX order: the
        pretrained backbone (`model_params.pretrained`), then the transfer
        checkpoint (`transfer_learning_params.pretrained_path`); `where`
        names the wrapper in the transfer's messages."""
        if self.model_params.get("pretrained"):
            maybe_load_pretrained_backbone(self.model.backbone,
                                           self.model_params, self.vit_cfg)
        tl_path = self.transfer_learning_params.get("pretrained_path")
        if tl_path:
            transfer_into(self.model, tl_path, where=where)

    def init_optimization(self):
        opt = self.optimization_params.default
        self.optimizer = build_optimizer(
            opt.optimizer.type, dict(opt.optimizer.params),
            [(n, p) for n, p in self.model.named_parameters()
             if p.requires_grad],
            grad_clip=self.training_params.get("grad_clipping"))
        self.scheduler = LRScheduler(
            opt.scheduler.type, opt.scheduler.get("params", {}),
            max_lr=opt.optimizer.params.lr,
            steps_per_epoch=len(self.dataloaders.trainloader),
            epochs=self.training_params.epochs)
        self.state = TrainState(step=0, model=self.model,
                                optimizer=self.optimizer)
