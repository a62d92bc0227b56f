"""Recurrent layers (port of ``deeplearning4j_tpu/nn/layers/recurrent.py``).

The JAX package runs each cell as a ``lax.scan`` body; here the cell runs
in a Python loop over time on plain torch ops (no TPU kernel lies on this
path).  The input product of every timestep is hoisted out of the loop
as one ``torch.matmul`` over all T (:meth:`BaseRecurrentLayer.precompute_inputs`),
so the loop carries only the recurrent product.

- LSTM: gate order IFOG (input, forget, output, cell gate) in the packed
  ``W [nIn, 4H]``, ``U [H, 4H]``, ``b [4H]``; ``forget_gate_bias_init``
  (default 1.0) fills the forget block of b.  GravesLSTM adds diagonal
  peephole weights ``wP [3H]`` (cell state into i and f from the previous
  cell, into o from the new one).
- SimpleRnn; GRU ("reset after": the bias sits in the input projection,
  ``c = act(zx_c + r * zh_c)``).
- Bidirectional (CONCAT, ADD, MUL, AVERAGE), BidirectionalLastStep,
  LastTimeStep, TimeDistributed, RnnOutputLayer, RnnLossLayer.

Layout NTC (batch, time, channels).  A mask ``[B, T]`` in {0, 1}: a masked
step carries the previous state through (``m * new + (1 - m) * old``) and
outputs zeros.  Carries and gate math run in at least f32; only the
``[B, T, H]`` output drops to the policy's output dtype.  A carry is a
tensor (SimpleRnn, GRU) or a tuple ``(h, c)`` (the LSTMs).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from deeplearning4j_tpu_torch.config import dtype_policy
from deeplearning4j_tpu_torch.nn import activations, losses
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict, register_layer
from deeplearning4j_tpu_torch.train.updaters import tree_map


def _last_index(mask: torch.Tensor) -> torch.Tensor:
    """Each row's last unmasked step, ``max(sum(mask) - 1, 0)``."""
    return torch.clamp(mask.sum(dim=1).to(torch.int64) - 1, min=0)


def _at_steps(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``y[b, idx[b], :]`` for each row b (``take_along_axis``)."""
    return torch.take_along_dim(y, idx[:, None, None], dim=1)[:, 0, :]


def _merge(mode: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = mode.lower()
    if m == "concat":
        return torch.cat([a, b], dim=-1)
    if m == "add":
        return a + b
    if m == "mul":
        return a * b
    if m == "average":
        return 0.5 * (a + b)
    raise ValueError(mode)


class _Wrapper:
    """Config plumbing of a layer that wraps another (``field``): a nested
    dict becomes a layer, defaults cascade into it, and its JSON nests."""

    _WRAPPED = "underlying"

    def __post_init__(self):
        inner = getattr(self, self._WRAPPED)
        if isinstance(inner, dict):
            setattr(self, self._WRAPPED, layer_from_dict(inner))

    def inherit_defaults(self, defaults):
        super().inherit_defaults(defaults)
        inner = getattr(self, self._WRAPPED)
        if inner is not None:
            inner.inherit_defaults(defaults)

    def to_dict(self):
        d = super().to_dict()
        d[self._WRAPPED] = getattr(self, self._WRAPPED).to_dict()
        return d


@dataclasses.dataclass
class BaseRecurrentLayer(Layer):
    n_out: int = 0

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def step(self, params, carry, x_t):
        """One timestep ``(carry, x_t [B, C]) -> (new_carry, y_t [B, H])``
        through the same :meth:`precompute_inputs` the loop uses, so the
        streaming path cannot drift from the training one."""
        pre = self.precompute_inputs(params, x_t)
        if pre is None:
            raise NotImplementedError
        return self.step_pre(params, carry, pre)

    def precompute_inputs(self, params, x):
        """The input projection of all timesteps at once, ``[B, T, C] ->
        [B, T, G]``; None where the cell has none."""
        return None

    def step_pre(self, params, carry, pre_t):
        """One timestep from the precomputed projection row ``pre_t [B, G]``."""
        raise NotImplementedError

    def _scan(self, params, x, mask, carry):
        """The cell over time from ``carry``, masked steps carried through;
        returns ``(y [B, T, H], final carry)``."""
        pre = self.precompute_inputs(params, x)
        cell = self.step if pre is None else self.step_pre
        seq = x if pre is None else pre
        ms = None if mask is None else mask.to(x.dtype)
        ys = []
        for t in range(seq.shape[1]):
            new_carry, y_t = cell(params, carry, seq[:, t])
            if ms is None:
                carry = new_carry
            else:
                m = ms[:, t, None]
                carry = tree_map(lambda new, old: m * new + (1.0 - m) * old, new_carry, carry)
                y_t = y_t * m
            ys.append(y_t)
        return torch.stack(ys, dim=1), carry

    def apply_with_carry(self, params, state, x, carry, *, train=False, rng=None, mask=None):
        """The forward from ``carry`` (zeros when None): ``(y, state,
        final carry)``.  tBPTT carries state across segments with it."""
        x = self._maybe_dropout(x, train, rng)
        if carry is None:
            carry = self.init_carry(x.shape[0], torch.promote_types(x.dtype, torch.float32),
                                    x.device)
        y, new_carry = self._scan(params, x, mask, carry)
        return y.to(dtype_policy().output_dtype), state, new_carry

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y, state, _ = self.apply_with_carry(params, state, x, None, train=train, rng=rng,
                                            mask=mask)
        return y, state


@register_layer("lstm")
@dataclasses.dataclass
class LSTM(BaseRecurrentLayer):
    """LSTM with IFOG packed weights; gates ``gate_activation`` (sigmoid),
    cell ``activation`` (tanh)."""

    gate_activation: Any = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def init_params(self, gen, input_type):
        n_in, h = input_type.size, self.n_out
        w = self._init_weight(gen, (n_in, 4 * h), n_in, h)
        u = self._init_weight(gen, (h, 4 * h), h, h)
        b = torch.zeros(4 * h, dtype=self._param_dtype())
        b[h:2 * h] = self.forget_gate_bias_init
        return {"W": w, "U": u, "b": b}

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return (torch.zeros(batch, self.n_out, dtype=dtype, device=device),
                torch.zeros(batch, self.n_out, dtype=dtype, device=device))

    def precompute_inputs(self, params, x):
        policy = dtype_policy()
        return torch.matmul(x.to(policy.compute_dtype), params["W"].to(policy.compute_dtype))

    def _gates_in(self, params, h_prev, pre_t):
        """``z = (pre_t + h U)`` in at least f32, plus b."""
        policy = dtype_policy()
        acc = torch.promote_types(policy.output_dtype, torch.float32)
        z = pre_t + torch.matmul(h_prev.to(policy.compute_dtype),
                                 params["U"].to(policy.compute_dtype))
        return z.to(acc) + params["b"].to(acc)

    def step_pre(self, params, carry, pre_t):
        h_prev, c_prev = carry
        hsz = self.n_out
        z = self._gates_in(params, h_prev, pre_t)
        gate = activations.get(self.gate_activation)
        cell_act = activations.get(self.activation or "tanh")
        i = gate(z[:, 0:hsz])
        f = gate(z[:, hsz:2 * hsz])
        o = gate(z[:, 2 * hsz:3 * hsz])
        g = cell_act(z[:, 3 * hsz:4 * hsz])
        c = f * c_prev + i * g
        h = o * cell_act(c)
        return (h, c), h


@register_layer("graves_lstm")
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """LSTM with peepholes ``wP [3H]``: the previous cell into i and f, the
    new cell into o."""

    def init_params(self, gen, input_type):
        params = super().init_params(gen, input_type)
        params["wP"] = torch.zeros(3 * self.n_out, dtype=self._param_dtype())
        return params

    def step_pre(self, params, carry, pre_t):
        h_prev, c_prev = carry
        hsz = self.n_out
        z = self._gates_in(params, h_prev, pre_t)
        gate = activations.get(self.gate_activation)
        cell_act = activations.get(self.activation or "tanh")
        wp = params["wP"]
        i = gate(z[:, 0:hsz] + wp[0:hsz] * c_prev)
        f = gate(z[:, hsz:2 * hsz] + wp[hsz:2 * hsz] * c_prev)
        g = cell_act(z[:, 3 * hsz:4 * hsz])
        c = f * c_prev + i * g
        o = gate(z[:, 2 * hsz:3 * hsz] + wp[2 * hsz:3 * hsz] * c)
        h = o * cell_act(c)
        return (h, c), h


@register_layer("simple_rnn")
@dataclasses.dataclass
class SimpleRnn(BaseRecurrentLayer):
    """h_t = act(x_t W + h_{t-1} U + b)."""

    def init_params(self, gen, input_type):
        n_in, h = input_type.size, self.n_out
        return {"W": self._init_weight(gen, (n_in, h), n_in, h),
                "U": self._init_weight(gen, (h, h), h, h),
                "b": self._init_bias((h,))}

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return torch.zeros(batch, self.n_out, dtype=dtype, device=device)

    def precompute_inputs(self, params, x):
        return torch.matmul(x, params["W"])

    def step_pre(self, params, carry, pre_t):
        act = activations.get(self.activation or "tanh")
        h = act(pre_t + torch.matmul(carry, params["U"]) + params["b"])
        return h, h


@register_layer("gru")
@dataclasses.dataclass
class GRU(BaseRecurrentLayer):
    """GRU, packed ``[*, 3H]`` in r, u, c order, reset applied after the
    recurrent product."""

    gate_activation: Any = "sigmoid"

    def init_params(self, gen, input_type):
        n_in, h = input_type.size, self.n_out
        return {"W": self._init_weight(gen, (n_in, 3 * h), n_in, h),
                "U": self._init_weight(gen, (h, 3 * h), h, h),
                "b": self._init_bias((3 * h,))}

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return torch.zeros(batch, self.n_out, dtype=dtype, device=device)

    def precompute_inputs(self, params, x):
        return torch.matmul(x, params["W"]) + params["b"]

    def step_pre(self, params, carry, zx):
        h = self.n_out
        gate = activations.get(self.gate_activation)
        act = activations.get(self.activation or "tanh")
        zh = torch.matmul(carry, params["U"])
        r = gate(zx[:, 0:h] + zh[:, 0:h])
        u = gate(zx[:, h:2 * h] + zh[:, h:2 * h])
        c = act(zx[:, 2 * h:3 * h] + r * zh[:, 2 * h:3 * h])
        new_h = u * carry + (1.0 - u) * c
        return new_h, new_h


@register_layer("bidirectional")
@dataclasses.dataclass
class Bidirectional(_Wrapper, Layer):
    """A recurrent layer run forward and over the reversed sequence (its own
    params, ``{"fwd", "bwd"}``), the two outputs merged by ``mode``."""

    _WRAPPED = "fwd"

    fwd: Any = None
    mode: str = "concat"

    def get_output_type(self, input_type: InputType) -> InputType:
        inner = self.fwd.get_output_type(input_type)
        size = inner.size * 2 if self.mode == "concat" else inner.size
        return InputType.recurrent(size, inner.timesteps)

    def init_params(self, gen, input_type):
        return {"fwd": self.fwd.init_params(gen, input_type),
                "bwd": self.fwd.init_params(gen, input_type)}

    def _both(self, params, x, train, rng, mask):
        """The forward run's output and the reversed run's, unflipped."""
        y_f, _ = self.fwd.apply(params["fwd"], {}, x, train=train, rng=rng, mask=mask)
        mask_rev = None if mask is None else torch.flip(mask, dims=(1,))
        y_b, _ = self.fwd.apply(params["bwd"], {}, torch.flip(x, dims=(1,)), train=train,
                                rng=rng, mask=mask_rev)
        return y_f, y_b

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y_f, y_b = self._both(params, x, train, rng, mask)
        return _merge(self.mode, y_f, torch.flip(y_b, dims=(1,))), state


@register_layer("bidirectional_last")
@dataclasses.dataclass
class BidirectionalLastStep(Bidirectional):
    """Bidirectional collapsed to its final states: the forward run's last
    valid step merged with the reversed run's final state (its step T-1:
    a right-padded mask reverses to left padding)."""

    def transform_mask(self, mask):
        return None

    def get_output_type(self, input_type):
        inner = self.fwd.get_output_type(input_type)
        size = inner.size * 2 if self.mode == "concat" else inner.size
        return InputType.feed_forward(size)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y_f, y_b = self._both(params, x, train, rng, mask)
        f_last = y_f[:, -1, :] if mask is None else _at_steps(y_f, _last_index(mask))
        return _merge(self.mode, f_last, y_b[:, -1, :]), state


@register_layer("last_time_step")
@dataclasses.dataclass
class LastTimeStep(_Wrapper, Layer):
    """A recurrent layer's last unmasked step as a feed-forward vector."""

    underlying: Any = None

    def transform_mask(self, mask):
        return None

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.underlying.get_output_type(input_type).size)

    def init_params(self, gen, input_type):
        return self.underlying.init_params(gen, input_type)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y, state = self.underlying.apply(params, state, x, train=train, rng=rng, mask=mask)
        if mask is None:
            return y[:, -1, :], state
        return _at_steps(y, _last_index(mask)), state


@register_layer("time_distributed")
@dataclasses.dataclass
class TimeDistributed(_Wrapper, Layer):
    """A feed-forward layer at every timestep: ``[B, T, C]`` as ``[B*T, C]``
    through it and back."""

    underlying: Any = None

    def get_output_type(self, input_type: InputType) -> InputType:
        inner = self.underlying.get_output_type(InputType.feed_forward(input_type.size))
        return InputType.recurrent(inner.size, input_type.timesteps)

    def init_params(self, gen, input_type):
        return self.underlying.init_params(gen, InputType.feed_forward(input_type.size))

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        b, t, c = x.shape
        y, state = self.underlying.apply(params, state, x.reshape(b * t, c), train=train,
                                         rng=rng)
        return y.reshape(b, t, -1), state


def _score_per_step(loss, labels, z, activation):
    """The loss at every step, ``[B, T]``, with time flattened into the
    batch; the loss math in at least f32."""
    z = z.to(torch.promote_types(z.dtype, torch.float32))
    b, t = z.shape[0], z.shape[1]
    score = losses.get(loss)(labels.reshape(b * t, -1), z.reshape(b * t, -1),
                             activation or "identity", None)
    return score.reshape(b, t)


@register_layer("rnn_output")
@dataclasses.dataclass
class RnnOutputLayer(Layer):
    """Per-timestep dense + loss: ``[B, T, C] -> [B, T, nOut]``, the score
    per step (``[B, T]``)."""

    n_out: int = 0
    loss: Any = "mcxent"
    has_bias: bool = True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init_params(self, gen, input_type):
        n_in = input_type.size
        params = {"W": self._init_weight(gen, (n_in, self.n_out), n_in, self.n_out)}
        if self.has_bias:
            params["b"] = self._init_bias((self.n_out,))
        return params

    def pre_output(self, params, state, x, *, train=False, rng=None):
        x = self._maybe_dropout(x, train, rng)
        policy = dtype_policy()
        z = torch.matmul(x.to(policy.compute_dtype), params["W"].to(policy.compute_dtype))
        if self.has_bias:
            z = z + params["b"].to(z.dtype)
        return z.to(policy.output_dtype)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        z = self.pre_output(params, state, x, train=train, rng=rng)
        return activations.get(self.activation or "identity")(z), state

    def compute_score_array(self, params, state, x, labels, *, train=False, rng=None,
                            mask=None):
        z = self.pre_output(params, state, x, train=train, rng=rng)
        return _score_per_step(self.loss, labels, z, self.activation)

    def apply_and_score(self, params, state, x, labels, *, train=False, rng=None, mask=None):
        """``apply`` and ``compute_score_array`` from one product (and one
        dropout mask): ``(output, state, [B, T] loss)``."""
        z = self.pre_output(params, state, x, train=train, rng=rng)
        y = activations.get(self.activation or "identity")(z)
        return y, state, _score_per_step(self.loss, labels, z, self.activation)


@register_layer("rnn_loss")
@dataclasses.dataclass
class RnnLossLayer(Layer):
    """Per-timestep loss on its input, no params."""

    loss: Any = "mcxent"

    def has_params(self) -> bool:
        return False

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return activations.get(self.activation or "identity")(x), state

    def compute_score_array(self, params, state, x, labels, *, train=False, rng=None,
                            mask=None):
        return _score_per_step(self.loss, labels, x, self.activation)

    def apply_and_score(self, params, state, x, labels, *, train=False, rng=None, mask=None):
        y, state = self.apply(params, state, x)
        return y, state, self.compute_score_array(params, state, x, labels)
