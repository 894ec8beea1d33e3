"""THuman 2.1 (stage-1 training; the JAX package's data/thuman.py).

The rendered-THuman layout:

    <dataset_root>/<subj>/12views_3/render/*.png     multi-view renders
    <dataset_root>/<subj>/12views_3/calib/*.json     per-view extrinsic (E) and intrinsic (K)
    <dataset_root>/<subj>/12views_3/vertices.npy     ground-truth point cloud
    <smplx_params_path>/<subj>/smplx_param.pkl       SMPL-X parameters

with global_orient zeroed, transl fixed to (0, 0.35, 0), fx = fy = 5000 and
c = 512 where a calib file has no intrinsic, one front-ish reference view
and n_test - 1 random target views. Each item is (ref, test, idx), B = 1,
numpy. The draws follow the JAX reader's: one `random.Random` a split (seed
0 for train, 1 for the others) consumed in the same order (the shuffle in
`__iter__`, then `choice` and `sample` in each `__getitem__`), and the
point-cloud subset from `np.random.RandomState(idx)`. The PNGs decode
without PIL (utils/images.py), to the same pixels.
"""

from __future__ import annotations

import json
import os
import pickle
import random

import numpy as np

from ..utils.images import read_png, resize
from .containers import VideoBatch

FRONT_VIEWS = (0, 1, 11)  # front-ish view indices in the 12-view rig
INTRINSIC = np.array([[5000.0, 0, 512.0], [0, 5000.0, 512.0], [0, 0, 1.0]],
                     np.float32)
FIXED_TRANSL = np.array([0.0, 0.35, 0.0], np.float32)


def load_image(path, image_size):
    """PIL's open, convert("RGB") and resize((W, H)) of a PNG -> (3, H, W)
    float32 in [0, 1]."""
    img = read_png(path, "RGB")
    if img.shape[:2] != tuple(image_size):
        img = resize(img, (image_size[1], image_size[0]))
    return img.astype(np.float32).transpose(2, 0, 1) / 255.0


def load_smplx_pkl(path, num_expr=10):
    with open(path, "rb") as f:
        raw = pickle.load(f, encoding="latin1")

    def get(key, n):
        v = np.asarray(raw.get(key, np.zeros(n)), np.float32).reshape(-1)
        out = np.zeros(n, np.float32)
        out[: min(n, v.size)] = v[:n]
        return out

    return {
        "global_orient": np.zeros(3, np.float32),
        "body_pose": get("body_pose", 63),
        "betas": get("betas", 10),
        "left_hand_pose": get("left_hand_pose", 45),
        "right_hand_pose": get("right_hand_pose", 45),
        "jaw_pose": get("jaw_pose", 3),
        "leye_pose": get("leye_pose", 3),
        "reye_pose": get("reye_pose", 3),
        "expression": get("expression", num_expr),
        "transl": FIXED_TRANSL.copy(),
    }


class ThumanDataset:
    def __init__(self, cfg, split: str = "train"):
        ds = cfg.dataset
        self.image_size = tuple(ds.image_size)
        self.n_test = int(ds.get("n_test", 8))
        self.pcd_nums = int(ds.get("pcd_nums", 30000))
        self.num_expr = int(ds.get("num_expression_coeffs", 10))
        self.batch_size = int(cfg.training.batch_size) if split == "train" else 1
        self.rng = random.Random(0 if split == "train" else 1)

        root = ds.get("dataset_root")
        if not root or not os.path.isdir(str(root)):
            raise FileNotFoundError(
                f"THuman dataset_root not found: {root!r}. Configure "
                "dataset.dataset_root or use the synthetic dataset.")
        self.root = str(root)
        self.smplx_root = str(ds.get("smplx_params_path") or self.root)

        list_path = ds.get(f"{split}_list")
        if list_path and os.path.exists(str(list_path)):
            with open(str(list_path)) as f:
                subjects = [ln.strip() for ln in f if ln.strip()]
        else:
            subjects = sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d, "12views_3")))
        self.items = []
        for subj in subjects:
            render_dir = os.path.join(self.root, subj, "12views_3", "render")
            if not os.path.isdir(render_dir):
                continue
            imgs = sorted(f for f in os.listdir(render_dir) if f.endswith(".png"))
            if imgs:
                self.items.append((subj, imgs))

    def __len__(self):
        return len(self.items)

    def _load_view(self, subj, img_name):
        base = os.path.join(self.root, subj, "12views_3")
        img = load_image(os.path.join(base, "render", img_name), self.image_size)
        with open(os.path.join(base, "calib", img_name.replace(".png", ".json"))) as f:
            calib = json.load(f)
        E = np.asarray(calib.get("extrinsic", calib.get("E", np.eye(4))),
                       np.float32).reshape(4, 4)
        K = np.asarray(calib.get("intrinsic", INTRINSIC), np.float32).reshape(3, 3)
        return img, K, E

    def __getitem__(self, idx):
        subj, imgs = self.items[idx % len(self.items)]
        n_views = len(imgs)
        ref_i = self.rng.choice([v for v in FRONT_VIEWS if v < n_views] or [0])
        test_is = self.rng.sample([i for i in range(n_views) if i != ref_i],
                                  min(self.n_test - 1, n_views - 1))
        smplx = load_smplx_pkl(os.path.join(self.smplx_root, subj, "smplx_param.pkl"),
                               self.num_expr)

        def build(view_ids):
            vids, Ks, Es = [], [], []
            for v in view_ids:
                img, K, E = self._load_view(subj, imgs[v])
                vids.append(img)
                Ks.append(K)
                Es.append(E)
            T = len(view_ids)
            smpl = {k: np.tile(v[None, None], (1, T) + (1,) * v.ndim)
                    for k, v in smplx.items()}
            cam = {"intrinsic": np.stack(Ks)[None], "extrinsic": np.stack(Es)[None]}
            return VideoBatch(video=np.stack(vids)[None], smpl_parms=smpl, cam_parms=cam,
                              width=self.image_size[1], height=self.image_size[0])

        ref = build([ref_i])
        test = build(test_is)
        pcd_path = os.path.join(self.root, subj, "12views_3", "vertices.npy")
        if os.path.exists(pcd_path):
            pts = np.load(pcd_path).astype(np.float32)
            sel = np.random.RandomState(idx).permutation(len(pts))[: self.pcd_nums]
            ref = ref._replace(pcd_points=pts[sel][None])
        return ref, test, idx

    def __iter__(self):
        order = list(range(len(self)))
        self.rng.shuffle(order)
        for i in order:
            yield self[i]
