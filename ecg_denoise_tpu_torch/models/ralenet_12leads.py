"""12-lead transfer wrapper (JAX counterpart: models/ralenet_12leads.py;
reference model/ralenet_12leads.py:680-709).

`NewRale` compresses 12 leads to the 2-lead space of a pretrained RA-LENet
core (12->6->2 convs, k 13), runs the core, and expands back (2->6->12).
The core is frozen: `frozen_parameters()` names its parameters, which
`train.create_train_state(frozen=...)` keeps out of Adam (the JAX
package's `frozen_param_mask`), and its BatchNorms stay in eval mode while
the adapters train, as the JAX module calls the core with train=False (a
documented deviation from the reference, whose frozen core would still
update its running stats).

Attribute names are the reference's (`rale`, `conv1`..`conv4`), so the JAX
package's `newrale_variables` reads this module's weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ecg_denoise_tpu_torch.models.ralenet import RaleNet
from ecg_denoise_tpu_torch.ops.layers import Conv1d

SLOPE = 0.01


class NewRale(nn.Module):
    """NewRale on (B, 12, 256). Parameters are float32; `dtype` is the
    compute dtype, as in the JAX module."""

    in_channels = 12

    def __init__(self, variant: str = "full", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv1d(12, 6, 13, padding=6)
        self.conv2 = Conv1d(6, 2, 13, padding=6)
        self.rale = RaleNet(variant=variant, dtype=dtype)
        self.conv3 = Conv1d(2, 6, 13, padding=6)
        self.conv4 = Conv1d(6, 12, 13, padding=6)

    def train(self, mode: bool = True):
        """Train mode for the adapters; the frozen core stays in eval."""
        super().train(mode)
        self.rale.eval()
        return self

    def frozen_parameters(self) -> set[str]:
        """The names of the core's parameters, which stay frozen."""
        return {f"rale.{name}" for name, _ in self.rale.named_parameters()}

    def forward(self, x):
        x = F.leaky_relu(self.conv1(x.to(self.dtype)), SLOPE)
        x = F.leaky_relu(self.conv2(x), SLOPE)
        x = self.rale(x)
        x = F.leaky_relu(self.conv3(x), SLOPE)
        return self.conv4(x)
