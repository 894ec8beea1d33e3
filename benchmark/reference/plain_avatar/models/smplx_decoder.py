"""SMPL-X parameter decoder head: tokens -> MLP(1024, 512, 256) -> 10 heads,
rotations predicted in 6D and converted to axis-angle (fp32)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.rotations import rotation_6d_to_axis_angle

BODY_JOINTS = 22   # incl. root
HAND_JOINTS = 15
SHAPE_DIM = 10


class SMPLXDecoder(nn.Module):
    def __init__(self, token_dim: int, token_len: int,
                 num_expression_coeffs: int = 10):
        super().__init__()
        self.mlp1 = nn.Linear(token_dim * token_len, 1024)
        self.mlp2 = nn.Linear(1024, 512)
        self.mlp3 = nn.Linear(512, 256)
        self.body_root_pose = nn.Linear(256, 6)
        self.body_pose = nn.Linear(256, (BODY_JOINTS - 1) * 6)
        self.body_shape = nn.Linear(256, SHAPE_DIM)
        self.transl = nn.Linear(256, 3)
        self.hand_pose = nn.Linear(256, 2 * HAND_JOINTS * 6)
        self.face_expression = nn.Linear(256, num_expression_coeffs)
        self.face_jaw_pose = nn.Linear(256, 6)
        self.leye_pose = nn.Linear(256, 6)
        self.reye_pose = nn.Linear(256, 6)

    def forward(self, tokens: torch.Tensor) -> dict:
        """tokens: (B, C, S) channel-first -> param dict of (B, ...)."""
        B = tokens.shape[0]
        h = torch.relu(self.mlp1(tokens.reshape(B, -1).float()))
        h = torch.relu(self.mlp2(h))
        feats = torch.relu(self.mlp3(h))
        hands6 = self.hand_pose(feats)
        n = HAND_JOINTS * 6
        aa = rotation_6d_to_axis_angle
        return {
            "betas": self.body_shape(feats),
            "transl": self.transl(feats),
            "global_orient": aa(self.body_root_pose(feats)),
            "body_pose": aa(self.body_pose(feats).reshape(B, BODY_JOINTS - 1, 6)),
            "left_hand_pose": aa(hands6[:, :n].reshape(B, HAND_JOINTS, 6)),
            "right_hand_pose": aa(hands6[:, n:].reshape(B, HAND_JOINTS, 6)),
            "jaw_pose": aa(self.face_jaw_pose(feats)),
            "leye_pose": aa(self.leye_pose(feats)),
            "reye_pose": aa(self.reye_pose(feats)),
            "expression": self.face_expression(feats),
        }
