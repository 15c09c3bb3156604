"""VOC-XML -> annotation-file generator + train/val splitter (counterpart of
``yolo_continuous_tpu/tools/gen_annotation.py``, standard library and numpy).

Parity target: ``tools/gen_annotation.py:18-135`` — the full offline
dataset-prep flow:
1. per-dataset ``trainval/test/train/val.txt`` index files with the
   9:1 / 9:1 split (seeded),
2. aggregated annotation lines ``img.jpg x1,y1,x2,y2,cls ...``
   (the format consumed by the datasets),
3. per-class counts table.

The same seed writes the JAX package's index and annotation files.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Sequence
from xml.etree.ElementTree import parse

import numpy as np


def convert_annotation(annot_file: str, classes: Sequence[str],
                       nums: np.ndarray) -> str:
    """One XML -> ' x1,y1,x2,y2,cls ...' suffix; tools/gen_annotation.py:18-36."""
    with open(annot_file, encoding="utf-8") as in_file:
        root = parse(in_file).getroot()
    parts = []
    for obj in root.iter("object"):
        difficult = 0
        if obj.find("difficult") is not None:
            difficult = obj.find("difficult").text
        cls = obj.find("name").text
        if cls not in classes or int(difficult) == 1:
            continue
        cls_id = classes.index(cls)
        bb = obj.find("bndbox")
        b = (int(float(bb.find("xmin").text)), int(float(bb.find("ymin").text)),
             int(float(bb.find("xmax").text)), int(float(bb.find("ymax").text)))
        parts.append(",".join(str(a) for a in b) + "," + str(cls_id))
        nums[cls_id] += 1
    return (" " + " ".join(parts)) if parts else ""


def gen_train_val_indexes(dataset_root: str, datasets: Sequence[str],
                          trainval_percent: float = 0.9,
                          train_percent: float = 0.9, seed: int = 0) -> None:
    """Split Annotations into trainval/test/train/val index files;
    tools/gen_annotation.py:39-87."""
    random.seed(seed)
    if " " in os.path.abspath(dataset_root):
        raise ValueError("dataset path must not contain spaces")
    for ds in datasets:
        annot_dir = os.path.join(dataset_root, ds, "Annotations")
        total = sorted(x for x in os.listdir(annot_dir) if x.endswith(".xml"))
        num = len(total)
        indexes = range(num)
        tv = int(num * trainval_percent)
        tr = int(tv * train_percent)
        trainval = set(random.sample(indexes, tv))
        train = set(random.sample(sorted(trainval), tr))
        files = {name: open(os.path.join(dataset_root, ds, f"{name}.txt"), "w")
                 for name in ("trainval", "test", "train", "val")}
        for i in indexes:
            name = total[i][:-4] + "\n"
            if i in trainval:
                files["trainval"].write(name)
                files["train" if i in train else "val"].write(name)
            else:
                files["test"].write(name)
        for f in files.values():
            f.close()


def gen_annotation(dataset_root: str, datasets: Sequence[str],
                   classes: Sequence[str]) -> Dict[str, int]:
    """Aggregate per-split annotation files; tools/gen_annotation.py:90-118.
    Returns the per-class box counts."""
    nums = np.zeros(len(classes))
    for split in ("train", "val", "test", "trainval"):
        out_file = os.path.join(dataset_root, f"{split}.txt")
        if os.path.exists(out_file):
            os.remove(out_file)
        for ds in datasets:
            idx_path = os.path.join(dataset_root, ds, f"{split}.txt")
            with open(idx_path, encoding="utf-8") as f:
                image_ids = f.read().strip().split()
            with open(out_file, "a", encoding="utf-8") as list_file:
                for image_id in image_ids:
                    image_file = os.path.join(dataset_root, ds, "JPEGImages",
                                              f"{image_id}.jpg")
                    annot_file = os.path.join(dataset_root, ds, "Annotations",
                                              f"{image_id}.xml")
                    list_file.write(image_file)
                    list_file.write(convert_annotation(annot_file, classes, nums))
                    list_file.write("\n")
    return {c: int(n) for c, n in zip(classes, nums)}


def prepare_voc(dataset_root: str, datasets: Sequence[str],
                classes: Sequence[str], trainval_percent: float = 0.9,
                train_percent: float = 0.9, seed: int = 0) -> Dict[str, int]:
    """Split + aggregate in one call (the reference __main__ flow)."""
    gen_train_val_indexes(dataset_root, datasets, trainval_percent,
                          train_percent, seed)
    counts = gen_annotation(dataset_root, datasets, classes)
    width = max(len(c) for c in classes) if classes else 1
    for c, n in counts.items():
        print(f"| {c.rjust(width)} | {n} |")
    return counts
