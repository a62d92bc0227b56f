"""InputType — shape inference between layers (port of
``deeplearning4j_tpu/nn/input_type.py``).

Convolutional data is NHWC at every public boundary, as in the JAX
package; layers permute to PyTorch's NCHW only around the torch op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str  # "ff" | "rnn" | "cnn" | "cnn_flat" | "cnn3d"
    size: int = 0                      # ff/rnn feature size
    timesteps: Optional[int] = None    # rnn (None = dynamic)
    height: int = 0
    width: int = 0
    channels: int = 0
    depth: int = 0                     # cnn3d
    dtype: Optional[str] = None        # None = the network default

    @staticmethod
    def feed_forward(size: int, dtype: Optional[str] = None) -> "InputType":
        return InputType(kind="ff", size=size, dtype=dtype)

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None,
                  dtype: Optional[str] = None) -> "InputType":
        return InputType(kind="rnn", size=size, timesteps=timesteps, dtype=dtype)

    @staticmethod
    def convolutional(height: int, width: int, channels: int,
                      dtype: Optional[str] = None) -> "InputType":
        return InputType(kind="cnn", height=height, width=width, channels=channels,
                         dtype=dtype)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int,
                           dtype: Optional[str] = None) -> "InputType":
        return InputType(kind="cnn_flat", height=height, width=width, channels=channels,
                         size=height * width * channels, dtype=dtype)

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int, channels: int,
                        dtype: Optional[str] = None) -> "InputType":
        return InputType(kind="cnn3d", depth=depth, height=height, width=width,
                         channels=channels, dtype=dtype)

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn", "cnn_flat"):
            return self.size if self.size else self.height * self.width * self.channels
        if self.kind == "cnn":
            return self.height * self.width * self.channels
        if self.kind == "cnn3d":
            return self.depth * self.height * self.width * self.channels
        raise ValueError(self.kind)

    def batch_shape(self, batch: int = 1) -> tuple:
        """Example array shape for a given batch size (NHWC / NTC)."""
        if self.kind in ("ff", "cnn_flat"):
            return (batch, self.flat_size())
        if self.kind == "rnn":
            return (batch, self.timesteps or 1, self.size)
        if self.kind == "cnn":
            return (batch, self.height, self.width, self.channels)
        if self.kind == "cnn3d":
            return (batch, self.depth, self.height, self.width, self.channels)
        raise ValueError(self.kind)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v not in (0, None) or k == "kind"}

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        known = {f.name for f in dataclasses.fields(InputType)}
        return InputType(**{k: v for k, v in d.items() if k in known})
