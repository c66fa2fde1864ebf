"""The port's side-car loops (`apla_tpu_torch.segdet`), the cases of the
JAX package's loop tests (tests/test_segdet_loop.py) but the mesh ones.

Detection: the loop, `--use_fused --bf16`, resume equal to an uninterrupted
run, eval-only, multi-scale training, an HF Swin checkpoint, SIGTERM; and
the CLI at the four-stage Swin-T width (`det --depths 2,2,6,2 --num_heads
3,6,12,24 --use_fused --bf16 --device cpu`) on a tiny synthetic COCO set.
Segmentation: the loop (train, mIoU, checkpoints), `--use_fused` with aux
heads and `head_lr_mult`, resume equal to an uninterrupted run, eval-only,
sliding-window evaluation, SIGTERM, and the CLI on a tiny ADE20K-layout
set.  The trajectories themselves are held against the JAX steps in
test_torch_detection.py and test_torch_seg.py.
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from apla_tpu_torch import segdet
from apla_tpu_torch.data.detection_data import write_png

KW = dict(img_size=56, batch_size=2, lr=1e-3, embed_dim=32, depths=(2, 2),
          num_heads=(1, 2), num_workers=0, log_every=1, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_coco(tmp_path, n_images=4, size=(60, 80)):
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(n_images):
        name = f"im{i}.png"
        img = rng.integers(0, 64, size + (3,), dtype=np.uint8)
        img[10:30, 10:40] = (200, 40, 40)
        write_png(str(img_dir / name), img)
        images.append({"id": i, "file_name": name, "width": size[1],
                       "height": size[0]})
        annotations.append({"id": 10 + i, "image_id": i, "category_id": 7,
                            "bbox": [10, 10, 30, 20], "iscrowd": 0})
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": 7, "name": "thing"}]}
    ann_file = tmp_path / "instances.json"
    ann_file.write_text(json.dumps(ann))
    return str(img_dir), str(ann_file)


def make_ade(root, n=4, size=(40, 50)):
    """A tiny ADE20K-layout set: PNG content under `.jpg` names, grey
    annotations with unlabelled (0) and class pixels."""
    rng = np.random.default_rng(0)
    for split in ("training", "validation"):
        os.makedirs(root / "images" / split)
        os.makedirs(root / "annotations" / split)
        for i in range(n):
            img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
            ann = np.zeros(size, np.uint8)
            ann[10:30, 10:40] = 2 + i % 3
            img[10:30, 10:40] = (40 * (i % 3), 200, 90)
            write_png(str(root / "images" / split / f"a{i}.jpg"), img)
            write_png(str(root / "annotations" / split / f"a{i}.png"), ann)
    return str(root)


SEG_KW = dict(img_size=32, patch_size=8, backbone="vit_tiny", batch_size=2,
              lr=1e-3, channels=16, num_workers=0, log_every=1,
              device="cpu")


def test_segmentation_loop(tmp_path):
    root = make_ade(tmp_path / "ade")
    ck = str(tmp_path / "ck")
    out = segdet.train_segmentation(root, epochs=2, save_dir=ck, **SEG_KW)
    assert out["iters"] == 4 and 0.0 <= out["best_miou"] <= 1.0
    for name in ("seg_best", "seg_last", "seg_frozen"):
        assert segdet._has_ckpt(ck, name)
    rows = [json.loads(line) for line in open(os.path.join(
        ck, "seg.metrics.jsonl"))]
    assert sum("train_loss" in r for r in rows) == 4
    assert all(set(r) == {"iters", "t", "epoch", "train_loss", "grad_norm",
                          "img_s"} for r in rows if "train_loss" in r)
    assert sum("val_miou" in r for r in rows) == 2
    best = segdet.load_checkpoint(os.path.join(ck, "seg_best.pt"))
    last = segdet.load_checkpoint(os.path.join(ck, "seg_last.pt"))
    assert "frozen" in best and "frozen" not in last
    assert "opt_state" in last and "opt_state" not in best
    # APLA "full": every block's whole projection, held once
    assert sorted(n for n in best["trainable"] if n.startswith(
        "backbone.")) == sorted(f"backbone.blocks.{i}.attn.proj.{w}"
                                for i in range(12) for w in ("kernel", "bias"))
    assert best["trainable"]["backbone.blocks.0.attn.proj.kernel"].shape == (
        192, 192)
    assert not any("attn.proj" in n or "attn.inds" in n
                   for n in best["frozen"])
    meta = json.loads(open(os.path.join(ck, "seg_last.json")).read())
    assert set(meta) == {"epoch", "miou"} and meta["epoch"] == 1


def test_segmentation_loop_fused_aux_heads(tmp_path):
    """`--use_fused --aux_heads 3 --head_lr_mult 10` on the CPU: the fused
    kernels' plain versions, the aux heads trained and checkpointed."""
    from apla_tpu_torch.ops import fused_apla_attn as fa
    root = make_ade(tmp_path / "ade")
    ck = str(tmp_path / "ck")
    before = (fa.fused_apla_attn_fwd.launches, fa.fused_apla_attn_bwd.launches)
    out = segdet.train_segmentation(root, epochs=1, save_dir=ck,
                                    use_fused=True, aux_heads=3,
                                    head_lr_mult=10.0, **SEG_KW)
    assert out["iters"] == 2 and 0.0 <= out["best_miou"] <= 1.0
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (fa.fused_apla_attn_fwd.launches,
            fa.fused_apla_attn_bwd.launches) == before
    best = segdet.load_checkpoint(os.path.join(ck, "seg_best.pt"))
    assert {n.split(".")[1] for n in best["trainable"]
            if n.startswith("aux_heads.")} == {"0", "1", "2"}


def test_segmentation_resume_matches_uninterrupted(tmp_path):
    """1 epoch + --resume for a 2nd == 2 uninterrupted epochs (seg_last
    carries the trainable tensors, both AdamW groups' state and the
    epoch); the best-mIoU race goes on from seg_best."""
    root = make_ade(tmp_path / "ade")
    kw = dict(SEG_KW, head_lr_mult=10.0, aux_heads=1)
    segdet.train_segmentation(root, epochs=2,
                              save_dir=str(tmp_path / "full"), **kw)
    segdet.train_segmentation(root, epochs=1,
                              save_dir=str(tmp_path / "part"), **kw)
    out = segdet.train_segmentation(root, epochs=2, resume=True,
                                    save_dir=str(tmp_path / "part"), **kw)
    assert out["iters"] == 2
    a, b = (segdet.load_checkpoint(str(tmp_path / d / "seg_last.pt"))
            for d in ("full", "part"))
    assert set(a["trainable"]) == set(b["trainable"])
    for name, t in a["trainable"].items():
        np.testing.assert_allclose(b["trainable"][name].numpy(), t.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    full_best = json.loads((tmp_path / "full" / "seg_best.json").read_text())
    assert out["best_miou"] == pytest.approx(full_best["miou"])


def test_segmentation_eval_only(tmp_path):
    root = make_ade(tmp_path / "ade")
    ck = str(tmp_path / "ck")
    segdet.train_segmentation(root, epochs=1, save_dir=ck, **SEG_KW)
    best = json.loads(open(os.path.join(ck, "seg_best.json")).read())
    out = segdet.train_segmentation(root, epochs=1, save_dir=ck,
                                    eval_only=True, **SEG_KW)
    assert out == {"best_miou": best["miou"], "iters": 0}
    with pytest.raises(FileNotFoundError, match="eval_only"):
        segdet.train_segmentation(root, epochs=1, eval_only=True,
                                  save_dir=str(tmp_path / "nope"), **SEG_KW)


def test_segmentation_slide_eval(tmp_path):
    """--eval_img_size above the crop: the validation set read at that
    size, logits from sliding windows of the crop; smaller is refused."""
    from apla_tpu_torch.models import seg as tseg
    root = make_ade(tmp_path / "ade")
    calls = []
    real = tseg.segmenter_slide_forward

    def spy(model, images, cfg, stride=None):
        calls.append((tuple(images.shape), stride))
        return real(model, images, cfg, stride=stride)

    segdet_slide = segdet.segmenter_slide_forward
    segdet.segmenter_slide_forward = spy
    try:
        out = segdet.train_segmentation(root, epochs=1, eval_img_size=48,
                                        eval_stride=16,
                                        save_dir=str(tmp_path / "ck"),
                                        **SEG_KW)
    finally:
        segdet.segmenter_slide_forward = segdet_slide
    assert out["iters"] == 2 and 0.0 <= out["best_miou"] <= 1.0
    assert calls == [((2, 48, 48, 3), 16)] * 2
    with pytest.raises(ValueError, match="eval_img_size"):
        segdet.train_segmentation(root, epochs=1, eval_img_size=16,
                                  save_dir=str(tmp_path / "ck2"), **SEG_KW)


def test_segmentation_preempted_run_saves_a_resumable_last(tmp_path,
                                                           monkeypatch):
    root = make_ade(tmp_path / "ade")
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(segdet, "_preemption_flag",
                        lambda: ((lambda: True), (lambda: None)))
    out = segdet.train_segmentation(root, epochs=1, save_dir=ck, **SEG_KW)
    assert out["preempted"] and out["iters"] == 1
    meta = json.loads((tmp_path / "ck" / "seg_last.json").read_text())
    assert meta["preempted"] and meta["epoch"] == -1
    monkeypatch.undo()
    out = segdet.train_segmentation(root, epochs=1, save_dir=ck,
                                    resume=True, **SEG_KW)
    assert out["iters"] == 2


def test_cli_seg(tmp_path, capsys):
    """`seg --use_fused --aux_heads 3 --head_lr_mult 10 --device cpu` at a
    small ViT, then `--eval_only`."""
    root = make_ade(tmp_path / "ade")
    ck = str(tmp_path / "ck")
    argv = ["seg", "--root", root, "--backbone", "vit_tiny", "--patch_size",
            "8", "--img_size", "32", "--batch_size", "2", "--epochs", "1",
            "--use_fused", "--aux_heads", "3", "--head_lr_mult", "10",
            "--num_workers", "0", "--device", "cpu", "--save_dir", ck]
    segdet.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["iters"] == 2 and 0.0 <= out["best_miou"] <= 1.0
    segdet.main(argv + ["--eval_only"])
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again == {"best_miou": out["best_miou"], "iters": 0}


def test_seg_use_fused_on_the_card_needs_bf16(tmp_path, monkeypatch):
    from apla_tpu_torch import wrapper
    from apla_tpu_torch.models.vit import VIT_BUILDERS
    root = make_ade(tmp_path / "ade")
    monkeypatch.setattr(wrapper, "resolve_device",
                        lambda name: torch.device("cuda"))
    cfg = VIT_BUILDERS["vit_tiny"](img_size=32, patch_size=8,
                                   compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        segdet.train_segmentation(root, vit_cfg=cfg, use_fused=True,
                                  save_dir=str(tmp_path), **SEG_KW)


def test_detection_loop(tmp_path):
    img_dir, ann = make_coco(tmp_path)
    out = segdet.train_detection(img_dir, ann, epochs=2,
                                 save_dir=str(tmp_path / "ck"), **KW)
    assert out["iters"] == 4 and out["eval_set"] == "train"
    assert 0.0 <= out["best_map50"] <= 1.0
    for name in ("det_best", "det_last", "det_frozen"):
        assert segdet._has_ckpt(str(tmp_path / "ck"), name)
    rows = [json.loads(line)
            for line in open(tmp_path / "ck" / "det.metrics.jsonl")]
    assert sum("train_loss" in r for r in rows) == 4
    assert sum("train_map50" in r for r in rows) == 2
    best = segdet.load_checkpoint(str(tmp_path / "ck" / "det_best.pt"))
    last = segdet.load_checkpoint(str(tmp_path / "ck" / "det_last.pt"))
    assert "frozen" in best and "frozen" not in last
    assert "opt_state" in last and "opt_state" not in best
    assert all(".attn.proj." in n for n in best["trainable"]
               if n.startswith("backbone."))
    meta = json.loads((tmp_path / "ck" / "det_last.json").read_text())
    assert set(meta) == {"epoch", "map50"} and meta["epoch"] == 1


def make_coco_masks(tmp_path, n_images=4, size=(60, 80)):
    """`make_coco`'s layout with non-rectangular objects: an ellipse per
    image, annotated in turn as a polygon, an uncompressed RLE, a
    compressed RLE (pycocotools' string code) and with no segmentation."""
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:size[0], :size[1]]
    images, annotations = [], []
    for i in range(n_images):
        name = f"im{i}.png"
        img = rng.integers(0, 64, size + (3,), dtype=np.uint8)
        x, y, w, h = 8 + 4 * i, 6 + 2 * i, 36, 28
        inside = ((xx + 0.5 - x - w / 2) / (w / 2)) ** 2 \
            + ((yy + 0.5 - y - h / 2) / (h / 2)) ** 2 <= 1
        img[inside] = (200, 40, 40)
        write_png(str(img_dir / name), img)
        images.append({"id": i, "file_name": name, "width": size[1],
                       "height": size[0]})
        ann = {"id": 10 + i, "image_id": i, "category_id": 7,
               "bbox": [x, y, w, h], "iscrowd": 0}
        flat = inside.T.reshape(-1).astype(int)
        edges = np.flatnonzero(np.diff(flat)) + 1
        counts = np.diff(np.concatenate([[0], edges, [flat.size]])).tolist()
        if i % 4 == 0:
            t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
            ann["segmentation"] = [np.stack(
                [x + w / 2 + w / 2 * np.cos(t),
                 y + h / 2 + h / 2 * np.sin(t)], 1).reshape(-1).tolist()]
        elif i % 4 in (1, 2):
            if i % 4 == 2:                 # compressed: rleToString
                chars = []
                for k, v in enumerate(counts):
                    v -= counts[k - 2] if k > 2 else 0
                    more = True
                    while more:
                        c, v = v & 0x1F, v >> 5
                        more = v != -1 if c & 0x10 else v != 0
                        chars.append(chr((c | 0x20 if more else c) + 48))
                counts = "".join(chars)
            ann["segmentation"] = {"size": list(size), "counts": counts}
        annotations.append(ann)
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": 7, "name": "thing"}]}
    ann_file = tmp_path / "instances.json"
    ann_file.write_text(json.dumps(ann))
    return str(img_dir), str(ann_file)


def test_detection_masks_loop_resume_eval_export_serve(tmp_path, capsys):
    """`det --masks` end to end: the loop trains the mask branch and
    reports box and mask mAP@50 (meta, log, result), `--eval_only` gives
    the best checkpoint's pair again, `--resume` keeps the saved bests
    when its epochs cannot beat them (as the JAX loop's test), then
    `export_det` (float and `--quantize_frozen`) writes `with_masks`
    artifacts whose `detect` masks equal `decode_detections` of the
    in-process forward, `serve eval` gives the loop's pair, and `serve
    predict` prints masks."""
    from apla_tpu_torch import serve
    from apla_tpu_torch.models.detection import (decode_detections,
                                                 detector_outputs)
    img_dir, ann = make_coco_masks(tmp_path)
    ck = str(tmp_path / "ck")
    kw = {**KW, "lr": 1e-2, "masks": True, "n_protos": 8}
    out = segdet.train_detection(img_dir, ann, epochs=3, save_dir=ck, **kw)
    assert out["iters"] == 6 and set(out) == {
        "best_map50", "best_mask_map50", "iters", "eval_set"}
    assert 0.0 <= out["best_mask_map50"] <= 1.0
    meta = json.loads((tmp_path / "ck" / "det_best.json").read_text())
    assert set(meta) == {"epoch", "map50", "mask_map50"}
    assert meta["mask_map50"] == out["best_mask_map50"]
    rows = [json.loads(line)
            for line in open(tmp_path / "ck" / "det.metrics.jsonl")]
    assert sum("mask_loss" in r for r in rows) == 6
    assert sum("train_mask_map50" in r for r in rows) == 3
    best = segdet.load_checkpoint(os.path.join(ck, "det_best.pt"))
    assert {"head.coef.kernel", "protonet.out.kernel"} <= set(
        best["trainable"])
    again = segdet.train_detection(img_dir, ann, epochs=1, save_dir=ck,
                                   eval_only=True, **kw)
    assert again["iters"] == 0
    assert again["best_map50"] == meta["map50"]
    assert again["best_mask_map50"] == meta["mask_map50"]
    # serve the best checkpoint: float and W8A8
    for extra in ([], ["--quantize_frozen"]):
        art = str(tmp_path / ("art" + "".join(extra)))
        serve.main(["export_det", "--ckpt", os.path.join(ck, "det_best.pt"),
                    "--img_size", "56", "--embed_dim", "32", "--depths",
                    "2,2", "--num_heads", "1,2", "--out", art,
                    "--batch_sizes", "1,2"] + extra)
        pred = serve.load_predictor(art, "cpu")
        assert pred.meta["with_masks"] is True
        assert pred.meta["quantized_frozen"] is bool(extra)
        # two images: one call at the exported batch size 2, so that the
        # W8A8 artifact's activation scales are those of the same batch
        x = np.random.default_rng(1).standard_normal(
            (2, 56, 56, 3)).astype(np.float32)
        dets = pred.detect(x, score_thresh=0.0, top_k=4)
        with torch.no_grad():
            levels, protos = detector_outputs(pred.model, torch.tensor(x),
                                              pred.swin_cfg)
        for j, det in enumerate(dets):
            want = decode_detections(
                [tuple(o[j:j + 1] for o in lvl) for lvl in levels],
                pred.meta["strides"], score_thresh=0.0, top_k=4,
                protos=protos[j:j + 1], mask_stride=4)
            assert len(det) == 4 and det[3].shape == (4, 14, 14)
            for g, w in zip(det, want):
                np.testing.assert_array_equal(g, w)
        capsys.readouterr()
        got = serve.main(["eval", art, "--det_img_dir", img_dir,
                          "--det_ann", ann, "--device", "cpu",
                          "--num_workers", "0"])
        if not extra:
            assert got == {"val_map50": round(meta["map50"], 4),
                           "val_mask_map50": round(meta["mask_map50"], 4)}
        np.save(tmp_path / "x.npy", x)
        serve.main(["predict", art, str(tmp_path / "x.npy"), "--device",
                    "cpu", "--score_thresh", "0", "--max_dets", "3"])
        recs = [json.loads(line) for line in
                capsys.readouterr().out.strip().splitlines()
                if line.startswith("{")]
        assert len(recs) == 2 and all(
            np.asarray(r["masks"]).shape == (3, 14, 14) for r in recs)
    # an unbeatable saved best: the resumed epoch keeps the meta's bests
    meta["mask_map50"], meta["map50"] = 2.0, 0.75
    (tmp_path / "ck" / "det_best.json").write_text(json.dumps(meta))
    out = segdet.train_detection(img_dir, ann, epochs=4, resume=True,
                                 save_dir=ck, **kw)
    assert out["iters"] == 2
    assert out["best_mask_map50"] == 2.0 and out["best_map50"] == 0.75


def test_detection_loop_fused_bf16_flags(tmp_path):
    """`--use_fused --bf16` on the CPU: the window kernels' plain versions
    in bf16, finite metrics and a checkpoint."""
    img_dir, ann = make_coco(tmp_path)
    out = segdet.train_detection(img_dir, ann, epochs=1, use_fused=True,
                                 bf16=True, save_dir=str(tmp_path / "ck"),
                                 **KW)
    assert out["iters"] == 2
    assert 0.0 <= out["best_map50"] <= 1.0
    assert segdet._has_ckpt(str(tmp_path / "ck"), "det_best")


def test_detection_resume_matches_uninterrupted(tmp_path):
    """1 epoch + --resume for a 2nd == 2 uninterrupted epochs: det_last
    carries the trainable tensors, the optimizer state and the epoch; the
    loader order is seeded by the epoch."""
    img_dir, ann = make_coco(tmp_path)
    segdet.train_detection(img_dir, ann, epochs=2,
                           save_dir=str(tmp_path / "full"), **KW)
    segdet.train_detection(img_dir, ann, epochs=1,
                           save_dir=str(tmp_path / "part"), **KW)
    out = segdet.train_detection(img_dir, ann, epochs=2, resume=True,
                                 save_dir=str(tmp_path / "part"), **KW)
    assert out["iters"] == 2            # only the second epoch ran
    a, b = (segdet.load_checkpoint(str(tmp_path / d / "det_last.pt"))
            for d in ("full", "part"))
    assert set(a["trainable"]) == set(b["trainable"])
    for name, t in a["trainable"].items():
        np.testing.assert_allclose(b["trainable"][name].numpy(), t.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_detection_eval_only(tmp_path):
    img_dir, ann = make_coco(tmp_path)
    ck = str(tmp_path / "ck")
    out = segdet.train_detection(img_dir, ann, epochs=1, save_dir=ck, **KW)
    again = segdet.train_detection(img_dir, ann, epochs=1, save_dir=ck,
                                   eval_only=True, **KW)
    assert again["iters"] == 0
    assert again["best_map50"] == out["best_map50"]
    with pytest.raises(FileNotFoundError, match="eval_only"):
        segdet.train_detection(img_dir, ann, epochs=1, eval_only=True,
                               save_dir=str(tmp_path / "nope"), **KW)


def test_detection_multi_scale(tmp_path):
    """--scales: one scale drawn per epoch, boxes in resized coordinates,
    evaluation at the base size; scales that break the window alignment
    are refused."""
    img_dir, ann = make_coco(tmp_path)
    out = segdet.train_detection(img_dir, ann, epochs=2, scales=(56, 112),
                                 save_dir=str(tmp_path / "ck"), **KW)
    assert out["iters"] == 4
    assert 0.0 <= out["best_map50"] <= 1.0
    with pytest.raises(ValueError, match="not divisible"):
        segdet.train_detection(img_dir, ann, epochs=1, scales=(84,),
                               save_dir=str(tmp_path / "ck2"), **KW)


def test_detection_loop_with_hf_swin_ckpt(tmp_path):
    """--swin_ckpt: a local HF SwinModel state_dict initialises the
    backbone; its architecture comes from the checkpoint."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.SwinModel(transformers.SwinConfig(
        image_size=56, patch_size=4, embed_dim=32, depths=[2, 2],
        num_heads=[1, 2], window_size=7), add_pooling_layer=False)
    ckpt = tmp_path / "swin_hf.pth"
    torch.save(hf.state_dict(), ckpt)
    img_dir, ann = make_coco(tmp_path)
    kw = {**KW, "embed_dim": 16, "depths": (2,), "num_heads": (4,)}
    out = segdet.train_detection(img_dir, ann, epochs=1, swin_ckpt=str(ckpt),
                                 save_dir=str(tmp_path / "ck"), **kw)
    assert out["iters"] == 2
    frozen = segdet.load_checkpoint(str(tmp_path / "ck" / "det_best.pt"))[
        "frozen"]
    np.testing.assert_array_equal(
        frozen["backbone.stages.1.blocks.1.attn.rel_bias"].numpy(),
        hf.state_dict()["encoder.layers.1.blocks.1.attention.self."
                        "relative_position_bias_table"].numpy())


def test_preemption_flag_sets_on_sigterm():
    old_term = signal.getsignal(signal.SIGTERM)
    old_int = signal.getsignal(signal.SIGINT)
    try:
        flag, restore = segdet._preemption_flag()
        assert not flag()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert flag()
        restore()
        assert signal.getsignal(signal.SIGTERM) is old_term
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)


def test_preempted_run_saves_a_resumable_last(tmp_path, monkeypatch):
    """A SIGTERM seen at a step boundary: det_last (marked at epoch - 1,
    `preempted`) is saved and the loop returns; --resume replays the epoch."""
    img_dir, ann = make_coco(tmp_path)
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(segdet, "_preemption_flag",
                        lambda: ((lambda: True), (lambda: None)))
    out = segdet.train_detection(img_dir, ann, epochs=1, save_dir=ck, **KW)
    assert out["preempted"] and out["iters"] == 1
    meta = json.loads((tmp_path / "ck" / "det_last.json").read_text())
    assert meta["preempted"] and meta["epoch"] == -1
    monkeypatch.undo()
    out = segdet.train_detection(img_dir, ann, epochs=1, save_dir=ck,
                                 resume=True, **KW)
    assert out["iters"] == 2


def test_cli_trains_the_four_stage_swin_t(tmp_path, capsys):
    """`det --depths 2,2,6,2 --num_heads 3,6,12,24 --use_fused --bf16
    --device cpu` at Swin-T's width (embed 96, 224 px) on two images."""
    img_dir, ann = make_coco(tmp_path, n_images=2, size=(224, 224))
    ck = str(tmp_path / "ck")
    segdet.main(["det", "--img_dir", img_dir, "--ann", ann, "--depths",
                 "2,2,6,2", "--num_heads", "3,6,12,24", "--use_fused",
                 "--bf16", "--device", "cpu", "--epochs", "1",
                 "--batch_size", "2", "--num_workers", "0", "--save_dir",
                 ck])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["iters"] == 1 and 0.0 <= out["best_map50"] <= 1.0
    best = segdet.load_checkpoint(os.path.join(ck, "det_best.pt"))
    projs = [n for n in best["trainable"] if ".attn.proj.kernel" in n]
    assert len(projs) == 12
    assert sum(best["trainable"][n].numel() for n in best["trainable"]
               if ".attn.proj." in n) == 2_160_960


def test_unported_options_raise(tmp_path, monkeypatch):
    """"tp" and "pp" over the side-cars' data-only mesh are the
    replicated placement, as JAX's `shard_params` gives them (a model
    axis of one: JAX's `_mesh_setup` places `param_sharding="pp"` over
    it), and stay off the CLI's choices, as in JAX; `--n_devices 2` and
    `--param_sharding fsdp` run (tests/test_torch_parallel_ssl.py), an
    unknown policy raises, and a batch that does not split over the ranks
    raises, as in JAX."""
    img_dir, ann = make_coco(tmp_path)
    root = make_ade(tmp_path / "ade")
    from apla_tpu_torch.models.vit import ViT, ViTConfig
    for policy in ("tp", "pp"):
        mesh = segdet._parallel_setup(1, policy, 2, "cpu")
        assert mesh.world == 1 and mesh.n_model == 1
        vit = ViT(ViTConfig(img_size=32, patch_size=8, embed_dim=64,
                            depth=2, num_heads=4))
        segdet._place(vit, mesh, policy, "seg")
        assert vit.placement is None and vit.pipeline is None
        assert all(p.numel() for p in vit.parameters())
    with pytest.raises(ValueError, match="unknown param_sharding"):
        segdet._parallel_setup(1, "zero", 2, "cpu")
    with pytest.raises(ValueError, match="not divisible by n_devices 3"):
        segdet.train_detection(img_dir, ann, save_dir=str(tmp_path),
                               **{**KW, "n_devices": 3})
    with pytest.raises(SystemExit):       # not a CLI choice
        segdet.main(["seg", "--root", root, "--param_sharding", "tp",
                     "--device", "cpu"])
    # on the card, --use_fused takes --bf16: no fall-back to the plain path
    from apla_tpu_torch import wrapper
    monkeypatch.setattr(wrapper, "resolve_device",
                        lambda name: torch.device("cuda"))
    with pytest.raises(ValueError, match="needs --bf16"):
        segdet.train_detection(img_dir, ann, use_fused=True,
                               save_dir=str(tmp_path), **KW)
