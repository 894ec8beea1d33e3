"""IDOL dataset (stage-1 training and evaluation on .npy scene caches; the
JAX package's data/idol.py).

The reference's cache format (src/datasets/dataset_idol.py):

  * scene dicts come from one or more .npy caches (allow_pickle, each
    repeated cache_repeat times). Two layouts: the reference layout
    ({'param_path': ...} whose .npy holds 'poses' / 'smpl_params' /
    'image_paths' / 'video_path') and the flat layout ({'img_paths',
    'intrinsic', 'extrinsic', 'smpl_param'}).
  * scenes reference PNG files (transparent pixels composited to white) or
    videos decoded whole (`read_frames`, av / imageio / cv2 imported when
    called; pixels above 250 in every channel forced to white).
  * the front view is the camera whose optical axis best opposes the
    SMPL-X global orient (`find_front_camera_by_rotation`), optionally
    jittered within +-allow_k_angles_near_the_front degrees.
  * view sampling: better_range stratified selection, first_is_front
    duplicating the front view at positions 0 (input) and 1 (supervision).
  * crop / scale augmentation of the reference view only
    (`crop_augment_ref`, `random_scale_and_crop`).
  * test mode: cond = the front view, targets = front + every view in
    order; test_pose_override replaces the target cameras by the
    `prepare_camera` look-at ring.
  * the 189-d packed smpl_param splits as [scale 1 | transl 3 |
    global_orient 3 | body_pose 63 | betas 10 | lhand 45 | rhand 45 |
    jaw 3 | leye 3 | reye 3 | expression 10].
  * __getitem__ falls back to scene 0 when a scene fails, as the reference.

The draws are the JAX reader's, from one `random.Random(0)` a dataset in
the same order; under the prefetch ring's threads they depend on timing,
as there. Images decode without PIL (utils/images.py: Pillow's RGBA / RGB
conversions and its bilinear resize, the same pixels); PNG is the image
format read.
"""

from __future__ import annotations

import math
import os
import random

import numpy as np

from ..utils import images
from .containers import VideoBatch

SMPL_SPLIT = [1, 3, 3, 63, 10, 45, 45, 3, 3, 3, 10]
SMPL_KEYS = ["scale", "transl", "global_orient", "body_pose", "betas",
             "left_hand_pose", "right_hand_pose", "jaw_pose", "leye_pose",
             "reye_pose", "expression"]
DEFAULT_FOCAL = 1120.0  # dataset_idol.py:142 (focal 80mm, sensor 32mm)


def unpack_smpl_189(vec: np.ndarray) -> dict:
    vec = np.asarray(vec, np.float32).reshape(-1)
    out = {}
    ofs = 0
    for k, n in zip(SMPL_KEYS, SMPL_SPLIT):
        out[k] = vec[ofs: ofs + n]
        ofs += n
    out.pop("scale")
    return out


# ---------------------------------------------------------------------------
# host-side geometry helpers
# ---------------------------------------------------------------------------

def _rotvec_to_matrix(rv: np.ndarray) -> np.ndarray:
    """Rodrigues (host numpy; mirrors ops/rotations semantics)."""
    rv = np.asarray(rv, np.float64).reshape(3)
    theta = np.linalg.norm(rv)
    if theta < 1e-12:
        return np.eye(3)
    k = rv / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * (K @ K)


def find_front_camera_by_rotation(poses, global_orient) -> int:
    """Index of the camera whose optical axis best opposes the body's
    facing direction (dataset_idol.py:840-855): body front = R(orient) @
    [0,0,-1]; camera forward = R_cam @ [0,0,1]; pick the minimum angle."""
    front = _rotvec_to_matrix(global_orient) @ np.array([0.0, 0.0, -1.0])
    best, best_idx = np.inf, 0
    for idx, pose in enumerate(poses):
        R = np.asarray(pose[0], np.float64)[:3, :3]
        cam_dir = R @ np.array([0.0, 0.0, 1.0])
        c = np.dot(cam_dir / np.linalg.norm(cam_dir),
                   front / np.linalg.norm(front))
        ang = math.acos(min(1.0, max(-1.0, c)))
        if ang < best:
            best, best_idx = ang, idx
    return best_idx


def read_frames(video_path: str):
    """Decode every frame of a video to RGB uint8 arrays
    (dataset_idol.py:857-874 uses PyAV; this env may not have it, so we
    fall back to imageio/cv2 — same output contract)."""
    try:
        import av
        container = av.open(video_path)
        stream = next(s for s in container.streams if s.type == "video")
        frames = []
        for packet in container.demux(stream):
            for frame in packet.decode():
                frames.append(frame.to_rgb().to_ndarray())
        return frames
    except ImportError:
        pass
    try:
        import imageio.v3 as iio
        return [np.asarray(f) for f in iio.imiter(video_path)]
    except Exception:
        import cv2
        cap = cv2.VideoCapture(video_path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if not frames:
            raise IOError(f"no frames decoded from {video_path}")
        return frames


def prepare_camera(resolution_x: int, resolution_y: int, num_views: int = 24,
                   strides: int = 1):
    """Synthetic look-at camera ring (dataset_idol.py:877-932): focal 40mm
    on a 32mm sensor scaled by the vertical resolution, radius-1.5 orbit,
    colmap convention (+z forward, +y down). Returns (K (3,3),
    [pose (4,4) c2w, ...])."""
    focal = 40.0 * (resolution_y / 32.0)
    K = np.array([[focal, 0, resolution_x // 2],
                  [0, focal, resolution_y // 2],
                  [0, 0, 1]], np.float32)

    def look_at(cam_pos, target, up):
        fwd = -(cam_pos - target) / np.linalg.norm(cam_pos - target)
        right = np.cross(up, fwd)
        up2 = np.cross(fwd, right)
        return np.column_stack((right, up2, fwd))

    poses = []
    for i in range(0, num_views, strides):
        phi = math.radians(90)
        theta = (i / num_views) * math.pi * 2
        pos = np.array([1.5 * math.sin(phi) * math.cos(theta),
                        1.5 * math.cos(phi),
                        -1.5 * math.sin(phi) * math.sin(theta)])
        pose = np.eye(4)
        pose[:3, :3] = look_at(pos, np.zeros(3), np.array([0.0, -1.0, 0.0]))
        pose[:3, 3] = pos
        poses.append(pose.astype(np.float32))
    return K, poses


# ---------------------------------------------------------------------------
# augmentation (dataset_idol.py:377-423, 955-997)
# ---------------------------------------------------------------------------

def _resize_hwc(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's Image.resize((w, h), BILINEAR) of the image cast to uint8."""
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.asarray(images.resize(arr, (w, h), "bilinear"), np.float32) / 255.0


def random_scale_and_crop(img: np.ndarray, scale_range=(0.8, 1.2),
                          rng: random.Random = random) -> np.ndarray:
    """Random zoom keeping the canvas size (dataset_idol.py:955-997):
    upscale -> center crop; downscale -> paste BOTTOM-aligned,
    horizontally centered, on a white canvas (feet stay grounded)."""
    h, w = img.shape[:2]
    s = rng.uniform(*scale_range)
    nh, nw = int(h * s), int(w * s)
    scaled = _resize_hwc(img, nh, nw)
    if nh > h or nw > w:
        top, left = (nh - h) // 2, (nw - w) // 2
        return scaled[top:top + h, left:left + w]
    canvas = np.ones((h, w, 3), np.float32)
    top, left = h - nh, (w - nw) // 2
    canvas[top:top + nh, left:left + nw] = scaled
    return canvas


def crop_augment_ref(img: np.ndarray, rng: random.Random = random) -> np.ndarray:
    """Reference-view crop augmentation (dataset_idol.py:378-423): with
    p=0.5 crop a head-to-upper-body window (jittered around h/7 and h/2,
    aspect 640:896), resize back to full, then random_scale_and_crop
    (0.8-1.2); otherwise just random_scale_and_crop (0.8-1.1)."""
    h, w = img.shape[:2]
    if rng.random() < 0.5:
        off_head = rng.randint(-h // 7, -h // 8)
        off_body = rng.randint(-h // 8, h // 8)
        head_y = max(0, min(h, h // 7 + off_head))
        body_y = max(0, min(h, h // 2 + off_body))
        crop_h = body_y - head_y
        crop_w = int(crop_h * 640 / 896)
        sx = max(0, min(w - crop_w, w // 2 - crop_w // 2))
        cropped = img[head_y:body_y, sx:sx + crop_w]
        if cropped.size == 0:
            return random_scale_and_crop(img, (0.8, 1.1), rng)
        full = _resize_hwc(cropped, h, w)
        return random_scale_and_crop(full, (0.8, 1.2), rng)
    return random_scale_and_crop(img, (0.8, 1.1), rng)


# ---------------------------------------------------------------------------
# image loading
# ---------------------------------------------------------------------------

def _load_image_white_bg(path: str) -> np.ndarray:
    """RGB float image with transparent pixels composited to white
    (dataset_idol.py:786-791). Returns (H, W, 3) in [0,1]."""
    with open(path, "rb") as f:
        img = images.decode_png(f.read())
    if img.mode in ("RGBA", "LA", "P"):
        arr = images.convert(img, "RGBA").astype(np.float32)
        alpha0 = arr[..., 3] == 0
        arr[alpha0, :3] = 255.0
        arr = arr[..., :3]
    else:
        arr = images.convert(img, "RGB").astype(np.float32)
    return arr / 255.0


def _video_frame_white_bg(frame: np.ndarray) -> np.ndarray:
    """Near-white video pixels forced pure white (dataset_idol.py:769-773)."""
    frame = np.array(frame[..., :3], copy=True)
    mask = np.all(frame > 250, axis=-1)
    frame[mask] = 255
    return frame.astype(np.float32) / 255.0


class AvatarDataset:
    def __init__(self, cfg, split: str = "train"):
        ds = cfg.dataset
        self.image_size = tuple(ds.image_size)          # (H, W)
        self.n_views = int(ds.get("specific_observation_num", 8))
        self.first_is_front = bool(ds.get("first_is_front", True))
        self.better_range = bool(ds.get("better_range", True))
        self.allow_k_angles = float(ds.get("allow_k_angles_near_the_front", 0))
        self.crop = bool(ds.get("crop", False)) and split == "train"
        self.test_mode = bool(ds.get("test_mode", False)) or split == "test"
        # reference test_pose_override (dataset_idol.py:140,742-744): replace
        # target poses with the prepare_camera look-at ring
        self.test_pose_override = bool(ds.get("test_pose_override", False))
        self.override_num_views = int(ds.get("override_num_views", 24))
        self.radius = float(ds.get("radius", 1.0))
        self.batch_size = int(cfg.training.batch_size) if split == "train" else 1
        self.rng = random.Random(0)

        paths = ds.get(f"cache_path_{split}") or []
        repeats = ds.get("cache_repeat") or [1] * len(paths)
        self.scenes = []
        for p, rep in zip(paths, repeats):
            if not os.path.exists(str(p)):
                continue
            data = np.load(str(p), allow_pickle=True)
            items = data.tolist() if hasattr(data, "tolist") else list(data)
            if isinstance(items, dict):
                items = list(items.values())
            self.scenes.extend(list(items) * int(rep))
        if not self.scenes:
            raise FileNotFoundError(
                f"No IDOL cache entries for split {split!r} (paths: {paths}). "
                "Configure dataset.cache_path_* or use the synthetic dataset.")

    def __len__(self):
        return len(self.scenes)

    # -- view selection (dataset_idol.py:246-274) --------------------------
    def _sample_views(self, n_avail: int, front: int):
        if self.test_mode:
            # parse_scene_test (:608-610): cond = [front, all views in order]
            return [front] + list(range(n_avail))
        k = min(self.n_views, n_avail)
        if self.first_is_front and k < 2:
            return [front, front]
        n_rand = k - 2 if self.first_is_front else k
        n_rand = max(1, min(n_rand, n_avail))
        if self.better_range:
            skip = max(1, n_avail // n_rand)
            perm = list(range(n_rand))
            self.rng.shuffle(perm)
            views = [min(p * skip + self.rng.randrange(skip), n_avail - 1)
                     for p in perm]
        else:
            views = self.rng.sample(range(n_avail), n_rand)
        if self.first_is_front:
            views = [front, front] + views
        return views[:max(k, 2)]

    def _front_view(self, poses, global_orient, n_avail: int) -> int:
        front = find_front_camera_by_rotation(poses, global_orient)
        if self.allow_k_angles > 0 and not self.test_mode:
            span = round(self.allow_k_angles / 360 * n_avail)
            if span > 0:
                front = (front + self.rng.randint(-span, span)) % n_avail
        return front

    # -- scene normalization ------------------------------------------------
    def _materialize(self, scene):
        """Resolve both cache layouts to
        (frames_source, poses, Ks or None, smpl_vec_or_per_view)."""
        scene = dict(scene)
        if "param_path" in scene:  # reference layout (:194-205)
            param = np.load(str(scene["param_path"]), allow_pickle=True).item()
            scene.update(param)
        video_path = scene.get("video_path")
        img_paths = scene.get("image_paths") or scene.get("img_paths") \
            or scene.get("images")
        if img_paths is None and video_path:
            source = ("video", read_frames(str(video_path)))
        else:
            source = ("paths", list(img_paths))
        return scene, source

    def _get_pose(self, scene, v: int) -> np.ndarray:
        """w2c extrinsic for view v, translation normalized by
        (center=0, radius) — gather_imgs' cam_to_ndc (:755-764)."""
        if "poses" in scene:
            pose = np.asarray(scene["poses"][v][0]
                              if isinstance(scene["poses"][v], (list, tuple))
                              else scene["poses"][v], np.float32).reshape(4, 4)
            E = pose.copy()
            E[:3, 3] = E[:3, 3] / self.radius
            return E
        return np.asarray(scene["extrinsic"][v], np.float32).reshape(4, 4)

    def _get_K(self, scene, v: int) -> np.ndarray:
        H, W = self.image_size
        intr = scene.get("intrinsic")
        if intr is None:
            intr = scene.get("intrinsics")
        if intr is None:
            fx = fy = DEFAULT_FOCAL
            return np.array([[fx, 0, W // 2], [0, fy, H // 2], [0, 0, 1]],
                            np.float32)
        arr = np.asarray(intr, np.float32)
        if arr.ndim > 2 or (arr.ndim == 2 and arr.shape[-1] not in (3, 4)):
            arr = arr[v]
        arr = np.asarray(arr, np.float32)
        if arr.shape == (3, 3):
            return arr
        vec = arr.reshape(-1)
        if vec.shape[0] == 3:  # old format: camera center, use defaults (:357)
            fx = fy = DEFAULT_FOCAL
            cx, cy = W // 2, H // 2
        else:
            fx, fy, cx, cy = vec[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    def _get_smpl(self, scene, v: int) -> dict:
        sp = scene.get("smpl_params", scene.get("smpl_param"))
        sp = np.asarray(sp, np.float32)
        if sp.ndim > 1:
            sp = sp[min(v, sp.shape[0] - 1)]
        return unpack_smpl_189(sp)

    def _load_frame(self, source, v: int) -> np.ndarray:
        kind, data = source
        H, W = self.image_size
        if kind == "video":
            img = _video_frame_white_bg(data[v % len(data)])
        else:
            img = _load_image_white_bg(data[v])
        if img.shape[:2] != (H, W):
            img = _resize_hwc(img, H, W)
        return img

    # -- item assembly -------------------------------------------------------
    def _load_scene(self, scene, idx):
        H, W = self.image_size
        scene, source = self._materialize(scene)
        n_avail = len(source[1])

        go = self._get_smpl(scene, 0)["global_orient"]
        poses = [(self._get_pose(scene, v), None) for v in range(n_avail)] \
            if "poses" in scene or "extrinsic" in scene else None
        front = self._front_view(poses, go, n_avail) if poses else 0
        views = self._sample_views(n_avail, front)

        frames, smpls, Ks, Es = [], [], [], []
        for j, v in enumerate(views):
            img = self._load_frame(source, v)
            if j == 0 and self.crop:
                img = crop_augment_ref(img, self.rng)
            frames.append(img.transpose(2, 0, 1))
            smpls.append(self._get_smpl(scene, v))
            Ks.append(self._get_K(scene, v))
            Es.append(self._get_pose(scene, v))

        def build(sel):
            video = np.stack([frames[j] for j in sel])[None]
            smpl = {k: np.stack([smpls[j][k] for j in sel])[None]
                    for k in smpls[0]}
            cam = {"intrinsic": np.stack([Ks[j] for j in sel])[None],
                   "extrinsic": np.stack([Es[j] for j in sel])[None]}
            return VideoBatch(video=video, smpl_parms=smpl, cam_parms=cam,
                              width=W, height=H)

        ref = build([0])
        test = build(list(range(1, len(views))))
        if self.test_mode and self.test_pose_override:
            # synthetic camera ring replaces the target poses
            # (dataset_idol.py:742-744 + prepare_camera :877-932); w2c from
            # the ring's c2w; images/smpl params keep the scene's content
            K, ring = prepare_camera(W, H, num_views=self.override_num_views)
            n_t = test.cam_parms["extrinsic"].shape[1]
            Es_o = np.stack([np.linalg.inv(ring[i % len(ring)])
                             for i in range(n_t)]).astype(np.float32)
            test.cam_parms["extrinsic"] = Es_o[None]
            test.cam_parms["intrinsic"] = np.tile(K[None, None], (1, n_t, 1, 1))
        return ref, test, idx

    def __getitem__(self, idx):
        try:
            return self._load_scene(self.scenes[idx % len(self.scenes)], idx)
        except Exception as e:  # noqa: BLE001 — reference behavior (:542-550)
            print(f"[idol] scene {idx} failed ({type(e).__name__}: {e}); "
                  "falling back to scene 0")
            return self._load_scene(self.scenes[0], idx)

    def __iter__(self):
        order = list(range(len(self)))
        self.rng.shuffle(order)
        for i in order:
            yield self[i]
