"""Anchor k-means over dataset box sizes (counterpart of
``yolo_continuous_tpu/tools/gen_anchors.py``, numpy only).

Parity target: ``tools/gen_anchors.py:14-132`` — k-means with the
``max(box/cluster, cluster/box)`` distance, median cluster update,
VOC-XML loading, sorted anchor output written to ``yolo_anchors.txt``.
The same seed gives the JAX package's anchors.

    python -m yolo_continuous_tpu_torch.tools.gen_anchors <VOC Annotations dir>
"""
from __future__ import annotations

import glob
import os
import xml.etree.ElementTree as ET
from typing import Optional, Tuple

import numpy as np


def cas_ratio(box: np.ndarray, cluster: np.ndarray) -> np.ndarray:
    """Distance = worst-side ratio; tools/gen_anchors.py:14-19."""
    ratios_bc = box / cluster
    ratios_cb = cluster / box
    return np.max(np.concatenate([ratios_bc, ratios_cb], axis=-1), -1)


def avg_ratio(box: np.ndarray, cluster: np.ndarray) -> float:
    return float(np.mean([np.min(cas_ratio(box[i], cluster))
                          for i in range(box.shape[0])]))


def kmeans(box: np.ndarray, k: int, seed: Optional[int] = None,
           verbose: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Median-update k-means with the ratio metric; tools/gen_anchors.py:26-69."""
    row = box.shape[0]
    rng = np.random.RandomState(seed)
    last = np.zeros((row,))
    cluster = box[rng.choice(row, k, replace=False)]
    it = 0
    while True:
        distance = np.stack([cas_ratio(box[i], cluster) for i in range(row)])
        near = np.argmin(distance, axis=1)
        if (last == near).all():
            break
        for j in range(k):
            members = box[near == j]
            if len(members):
                cluster[j] = np.median(members, axis=0)
        last = near
        if verbose and it % 5 == 0:
            print("iter: {:d}. avg_ratio:{:.2f}".format(it, avg_ratio(box, cluster)))
        it += 1
    return cluster, near


def load_voc_boxes(path: str) -> np.ndarray:
    """Normalized (w, h) pairs from a directory of VOC XMLs;
    tools/gen_anchors.py:72-93."""
    data = []
    for xml_file in glob.glob(os.path.join(path, "*xml")):
        tree = ET.parse(xml_file)
        height = int(tree.findtext("./size/height"))
        width = int(tree.findtext("./size/width"))
        if height <= 0 or width <= 0:
            continue
        for obj in tree.iter("object"):
            xmin = int(float(obj.findtext("bndbox/xmin"))) / width
            ymin = int(float(obj.findtext("bndbox/ymin"))) / height
            xmax = int(float(obj.findtext("bndbox/xmax"))) / width
            ymax = int(float(obj.findtext("bndbox/ymax"))) / height
            data.append([xmax - xmin, ymax - ymin])
    return np.array(data)


def plot_clusters(data: np.ndarray, cluster: np.ndarray, near: np.ndarray,
                  out_file: str = "kmeans_for_anchors.jpg") -> str:
    """Cluster scatter plot; tools/gen_anchors.py:111-117 (one color per
    cluster membership, black x at each center). Headless backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    for j in range(cluster.shape[0]):
        ax.scatter(data[near == j][:, 0], data[near == j][:, 1], s=8)
        ax.scatter(cluster[j][0], cluster[j][1], marker="x", c="black")
    ax.set_xlabel("box width (px)")
    ax.set_ylabel("box height (px)")
    fig.savefig(out_file, dpi=100)
    plt.close(fig)
    return out_file


def gen_anchors(annotation_dir: str, input_shape=(640, 640), anchors_num: int = 9,
                out_file: str = "yolo_anchors.txt", seed: int = 0,
                plot_file: str | None = None) -> np.ndarray:
    """Full flow of the reference __main__ (tools/gen_anchors.py:96-132),
    including the cluster scatter plot when ``plot_file`` is given."""
    data = load_voc_boxes(annotation_dir)
    cluster, near = kmeans(data, anchors_num, seed=seed)
    scale = np.array([input_shape[1], input_shape[0]])
    cluster = cluster * scale
    if plot_file:
        plot_clusters(data * scale, cluster, near, plot_file)
    cluster = cluster[np.argsort(cluster[:, 0] * cluster[:, 1])]
    with open(out_file, "w") as f:
        f.write(", ".join("%d,%d" % (c[0], c[1]) for c in cluster))
    return cluster


if __name__ == "__main__":
    import sys
    path = sys.argv[1] if len(sys.argv) > 1 else "data/annotations"
    print(gen_anchors(path))
