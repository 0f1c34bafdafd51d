"""The DiT's linear layer: ``nn.Linear`` (same parameters, same state-dict
names, same product), whose forward is one ``linear`` span of the tracer
(utils/timing.py), as ``Int8Linear``'s is.  The int8 swap
(ops/int8.py ``quantize_dit_``), LoRA's parametrization and the tp shards
(parallel/sharding.py) take it as any ``nn.Linear``."""

import torch.nn.functional as F
from torch import nn

from trajectorycrafter_tpu_torch.utils.timing import span


class Linear(nn.Linear):
    def forward(self, x):
        with span("linear", x):
            return F.linear(x, self.weight, self.bias)
