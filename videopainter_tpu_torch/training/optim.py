"""Optimizers and LR schedules.

Counterpart of `videopainter_tpu/training/optim.py` (reference get_optimizer:
AdamW defaults lr 1e-5, betas (0.9, 0.95), wd 1e-4, eps 1e-8; schedules as
diffusers' get_scheduler). The JAX package builds optax chains; here the same
arithmetic is written out on lists of tensors, updated in place, so the two
packages take the same steps from the same gradients:

 - schedules are plain functions of the step (python floats);
 - the global-norm clip is optax's: g * max_norm / max(norm, max_norm)
   (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm and differs);
 - each update rule (Adam / AdamW, Adafactor, Prodigy) as optax's, the
   schedule read at the count before it is advanced;
 - `accumulate_steps=k` as `optax.MultiSteps`: the running mean of k
   micro-gradients, then the whole chain (clip included) once, the parameters
   untouched in between.

`adafactor` and `prodigy` are written to `optax.adafactor` and
`optax.contrib.prodigy` (no PyTorch optimizer steps as they do).

ZeRO-2 (`Zero`, the counterpart of the JAX package's `opt_state_specs`):
over a `data` group of n ranks, the optimizer state of a stacked block leaf
(the tensors `transformer_blocks.<i>.<rest>` of all layers i that
`parallel/sharding.py` places, when n divides the layer count) is split by
layer: rank r holds and updates the layers [r L / n, (r + 1) L / n), and
after the step every rank's updated layers are all-gathered, so the
parameters stay equal on every rank. Gradients arrive averaged. Every
statistic that optax takes over a whole leaf or over all parameters (the
global-norm clip, Adafactor's update-clip and parameter-scale rms, Prodigy's
sums) is then a sum all-reduced over the group (`Zero.total`).
`Zero.gather_state` / `scatter_state` turn the state into the single-card
layout and back, so a checkpoint does not depend on the number of ranks.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def cosine_with_restarts_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                                  num_cycles: int = 1, final_lr: float = 0.0
                                  ) -> Callable[[int], float]:
    """Matches HF get_cosine_with_hard_restarts_schedule_with_warmup."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        if progress >= 1.0:
            return final_lr
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * ((progress * num_cycles) % 1.0)))

    return schedule


def make_lr_schedule(name: str, base_lr: float, *, warmup_steps: int = 0,
                     total_steps: int = 10000, num_cycles: int = 1,
                     power: float = 1.0) -> Callable[[int], float]:
    """The HF diffusers get_scheduler surface (linear | cosine |
    cosine_with_restarts | polynomial | constant | constant_with_warmup) as a
    step -> lr function."""
    name = name.lower()
    if name == "cosine_with_restarts":
        return cosine_with_restarts_schedule(base_lr, warmup_steps, total_steps, num_cycles)
    if name not in ("constant", "constant_with_warmup", "linear", "cosine", "polynomial"):
        raise ValueError(f"unknown lr_scheduler {name!r}")

    def schedule(step) -> float:
        step = float(step)
        if name == "constant":
            return base_lr
        if step < warmup_steps:
            return base_lr * min(step / max(warmup_steps, 1), 1.0)
        progress = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        if name == "constant_with_warmup":
            return base_lr
        if name == "linear":
            return base_lr * (1.0 - progress)
        if name == "cosine":
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * float(num_cycles) * 2.0 * progress))
        return base_lr * (1.0 - progress) ** power

    return schedule


def global_norm(grads: List[torch.Tensor], zero: Optional["Zero"] = None) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves, in fp32 (optax.global_norm);
    under ZeRO-2 over the leaves of every rank."""
    if zero is None:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))
    return torch.sqrt(zero.total([g.float().square().sum() for g in grads]))


def dist_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


# Adafactor's layout fields: which tensors form a block, in what shape, how
# it factors. They describe the state's own lists, so a ZeRO-2 state's are
# its rank's; the one-card layout leaves them out and takes them from `init`.
LAYOUT_KEYS = ("blocks", "shapes", "dims")

_LAYER = re.compile(r"^(\w+)\.(\d+)\.")


class Zero:
    """ZeRO-2 layout of a parameter list over a `data` group of n ranks
    (module note), and the cross-rank sums of the optimizer's statistics.
    `names`: the parameters' state-dict names; `shardable(name)`: whether a
    name is a placed block parameter (`parallel.sharding`). With n = 1 no
    state is split. `tp_group` / `tp_sharded(name)`: under tensor
    parallelism, the `model` group and the parameters that hold only this
    rank's rows or columns; their statistics also sum over that group."""

    def __init__(self, names: List[str], shapes: List[torch.Size], group, n: int, rank: int,
                 shardable: Callable[[str], bool], tp_group=None,
                 tp_sharded: Optional[Callable[[str], bool]] = None):
        self.group, self.n, self.rank = group, n, rank
        self.tp_group = tp_group
        self.full_names = list(names)
        groups: Dict[str, List[int]] = {}
        for i, name in enumerate(names):
            groups.setdefault(_LAYER.sub(r"\1.*.", name, count=1), []).append(i)
        self.owner = [None] * len(names)
        self.stacks: List[List[int]] = []   # sharded leaves: full indices in layer order
        for members in groups.values():
            m0 = names[members[0]]
            if (n == 1 or len(members) < 2 or _LAYER.match(m0) is None or not shardable(m0)
                    or len(members) % n or len({tuple(shapes[i]) for i in members}) > 1):
                continue
            members = sorted(members, key=lambda i: int(_LAYER.match(names[i]).group(2)))
            per = len(members) // n
            for pos, i in enumerate(members):
                self.owner[i] = pos // per
            self.stacks.append(members)
        self.local = [i for i, o in enumerate(self.owner) if o in (None, rank)]
        self.sharded = [self.owner[i] is not None for i in self.local]
        self.tp = [tp_group is not None and tp_sharded is not None and tp_sharded(names[i])
                   for i in self.local]
        self.stack_len = {i: len(st) for st in self.stacks for i in st}

    def local_names(self) -> List[str]:
        return [self.full_names[i] for i in self.local]

    def take(self, full: List) -> List:
        """This rank's entries of a full per-parameter list."""
        return [full[i] for i in self.local]

    def total(self, values: List[torch.Tensor]) -> torch.Tensor:
        """The sum over every rank's parameters of a per-parameter statistic
        given for the local ones: each term summed over the groups its
        parameter is split across, replicated terms counted once."""
        out = values[0].new_zeros(())
        for zs in (False, True):
            for ts in (False, True):
                part = [v for v, z, t in zip(values, self.sharded, self.tp) if (z, t) == (zs, ts)]
                if part:
                    out = out + self.sum_split(sum(part), zs, ts)
        return out

    def sum_split(self, value: torch.Tensor, zero_sharded: bool, tp_sharded: bool):
        """A partial sum over this rank's part, summed over the groups the
        part is split across."""
        from ..parallel.comm import all_reduce_
        if zero_sharded:
            value = all_reduce_(value.clone(), self.group)
        if tp_sharded:
            value = all_reduce_(value.clone(), self.tp_group)
        return value

    def split_count(self, zero_sharded: bool, tp_sharded: bool) -> int:
        return (self.n if zero_sharded else 1) * \
            (dist_size(self.tp_group) if tp_sharded else 1)

    def _gather_stack(self, stack: List[int], tensors: Dict[int, torch.Tensor]):
        """{full index: tensor} of every layer of a sharded leaf, from this
        rank's layers (all-gather; layers of equal shape)."""
        from ..parallel.comm import all_gather
        mine = [i for i in stack if self.owner[i] == self.rank]
        buf = torch.stack([tensors[i] for i in mine])
        full = all_gather(buf, 0, self.group)
        return dict(zip(stack, full.unbind(0)))

    @torch.no_grad()
    def sync_params(self, params_full: List[torch.Tensor]) -> None:
        """Copy every rank's updated layers into the others' parameters."""
        for stack in self.stacks:
            got = self._gather_stack(stack, {i: params_full[i].detach() for i in stack})
            for i in stack:
                if self.owner[i] != self.rank:
                    params_full[i].copy_(got[i])

    def gather_state(self, state: Dict) -> Dict:
        """The state in the single-card layout (a collective: every rank calls
        it). Per-parameter lists become full lists; the rest is kept."""
        out = {}
        pos = {i: j for j, i in enumerate(self.local)}
        for key, value in state.items():
            if not (isinstance(value, list) and len(value) == len(self.local)
                    and all(torch.is_tensor(v) for v in value)):
                out[key] = value
                continue
            full = [value[pos[i]] if i in pos else None for i in range(len(self.full_names))]
            for stack in self.stacks:
                got = self._gather_stack(stack, {i: full[i] for i in stack if i in pos})
                for i in stack:
                    full[i] = got[i]
            out[key] = full
        for key in LAYOUT_KEYS:
            out.pop(key, None)
        return out

    def scatter_state(self, full_state: Dict, template: Dict) -> Dict:
        """This rank's state from a single-card-layout one; `template` (from
        `init`) gives the per-parameter keys and the layout fields."""
        out = dict(template)
        for key, value in full_state.items():
            if key in template and isinstance(template[key], list) \
                    and len(template[key]) == len(self.local) and isinstance(value, list) \
                    and len(value) == len(self.full_names):
                out[key] = [v.to(t.device) for v, t in zip(self.take(value), template[key])]
            elif key not in LAYOUT_KEYS:
                out[key] = value
        return out


class _Adam:
    """optax.adam / adamw: bias-corrected moments, eps outside the root,
    decoupled weight decay added to the update before the learning rate."""

    def __init__(self, betas, eps, weight_decay):
        (self.b1, self.b2), self.eps, self.weight_decay = betas, eps, weight_decay

    def init(self, params, names=None, zero=None):
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def step_(self, params, grads, state, count, lr, zero=None):
        c1, c2 = 1.0 - self.b1 ** (count + 1), 1.0 - self.b2 ** (count + 1)
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """The two largest axes of a tensor with at least two axes of
    `min_dim_size_to_factor` (optax's choice, ties as numpy's argsort)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _leaf_blocks(params, names):
    """Which tensors form one leaf of the JAX package's tree, and in what
    shape: the per-layer tensors `<stack>.<i>.<rest>` of all layers i stack
    into one leaf, and a Conv2d weight [O, I, kh, kw] is held there as a
    matrix. Without names every tensor is a leaf of its own shape (the LoRA
    tree is stacked as the JAX one is). Returns (blocks, shapes): lists of
    parameter indices, and each parameter's shape inside its block."""
    if names is None:
        return [[i] for i in range(len(params))], [list(p.shape) for p in params]
    groups: Dict[str, List[int]] = {}
    for i, name in enumerate(names):
        groups.setdefault(re.sub(r"^(\w+)\.\d+\.", r"\1.*.", name), []).append(i)
    shapes = [[p.shape[0], p[0].numel()] if p.dim() == 4 else list(p.shape) for p in params]
    return list(groups.values()), shapes


class _Adafactor:
    """optax.adafactor at its defaults: second moment factored into row and
    column means where two axes have at least 128 entries (decay 1 - t^-0.8,
    eps 1e-30), update clipped to a block rms of 1, scaled by the learning
    rate and by the parameter's rms (at least 1e-3), no momentum, weight decay
    added last. A block is one leaf of the JAX package's tree (`_leaf_blocks`):
    the rms of the clip and of the parameter scale run over a leaf stacked
    across layers, so both packages take the same step on the same model.
    The moments are kept per tensor (each a row of its block's), so ZeRO-2
    can split a block by layer; under ZeRO-2 the factoring is chosen on the
    whole stacked leaf and the block rms are sums over every rank's layers."""

    def __init__(self, weight_decay):
        self.weight_decay = weight_decay

    @staticmethod
    def _stack(tensors, state, block):
        return torch.stack([tensors[i].reshape(state["shapes"][i]) for i in block])

    def init(self, params, names=None, zero=None):
        blocks, shapes = _leaf_blocks(params, names)
        n = len(params)
        state = {"blocks": blocks, "shapes": shapes, "dims": [],
                 "v_row": [None] * n, "v_col": [None] * n, "v": [None] * n}
        for block in blocks:
            stacked = [len(block)] + list(shapes[block[0]])
            if zero is not None and zero.sharded[block[0]]:
                stacked[0] = zero.stack_len[zero.local[block[0]]]
            dims = _factored_dims(stacked)
            if dims is not None and 0 in dims:
                raise ValueError(f"a stacked leaf of shape {stacked} factors over its layer "
                                 "axis: not supported")
            state["dims"].append(dims)
            for i in block:
                p = params[i].reshape(shapes[i])
                row = list(p.shape)
                drop = lambda d: row[:d - 1] + row[d:]
                one = p.new_zeros((1,))
                state["v_row"][i] = p.new_zeros(drop(dims[1])) if dims else one
                state["v_col"][i] = p.new_zeros(drop(dims[0])) if dims else one.clone()
                state["v"][i] = one.clone() if dims else torch.zeros_like(p)
        return state

    def step_(self, params, grads, state, count, lr, zero=None):
        decay = 1.0 - float(count + 1) ** -0.8

        def rms(x, split):
            """The rms of a block, over every rank's part of it."""
            if not any(split):
                return x.square().mean().sqrt()
            return (zero.sum_split(x.square().sum(), *split)
                    / (x.numel() * zero.split_count(*split))).sqrt()

        for b, block in enumerate(state["blocks"]):
            p, g = self._stack(params, state, block), self._stack(grads, state, block)
            split = (False, False) if zero is None else (zero.sharded[block[0]],
                                                         zero.tp[block[0]])
            dims = state["dims"][b]
            g_sq = g * g + 1e-30
            if dims is not None:
                d1, d0 = dims
                v_row = torch.stack([state["v_row"][i] for i in block])
                v_col = torch.stack([state["v_col"][i] for i in block])
                v_row.mul_(decay).add_(g_sq.mean(dim=d0), alpha=1 - decay)
                v_col.mul_(decay).add_(g_sq.mean(dim=d1), alpha=1 - decay)
                for t, i in enumerate(block):
                    state["v_row"][i].copy_(v_row[t])
                    state["v_col"][i].copy_(v_col[t])
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                update = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            else:
                v = torch.stack([state["v"][i] for i in block])
                v.mul_(decay).add_(g_sq, alpha=1 - decay)
                for t, i in enumerate(block):
                    state["v"][i].copy_(v[t])
                update = g * v ** -0.5
            update = update / torch.clamp(rms(update, split), min=1.0)
            update = update * lr * torch.clamp(rms(p, split), min=1e-3)
            if self.weight_decay:
                update = update + self.weight_decay * p
            for j, u in zip(block, update):
                params[j].sub_(u.reshape(params[j].shape))


class _Prodigy:
    """optax.contrib.prodigy: Adam on gradients scaled by an estimated step
    size d (from 1e-6), which grows with <g, p0 - p> over the summed |s|;
    decoupled weight decay. Its statistics are sums over all parameters, so
    they do not depend on how the parameters are cut into tensors."""

    D0, D_COEF = 1e-6, 1.0

    def __init__(self, betas, beta3, eps, weight_decay, safeguard_warmup):
        self.b1, self.b2 = betas
        self.b3 = self.b2 ** 0.5 if beta3 is None else beta3
        self.eps, self.weight_decay, self.safeguard_warmup = eps, weight_decay, safeguard_warmup

    def init(self, params, names=None, zero=None):
        zeros = lambda: [torch.zeros_like(p) for p in params]
        ref = params[0]
        return {"exp_avg": zeros(), "exp_avg_sq": zeros(), "grad_sum": zeros(),
                "params0": [p.detach().clone() for p in params],
                "estim_lr": torch.tensor(self.D0, dtype=ref.dtype, device=ref.device),
                "numerator_weighted": torch.zeros((), dtype=ref.dtype, device=ref.device)}

    def step_(self, params, grads, state, count, lr, zero=None):
        d = state["estim_lr"]
        bc = (1 - self.b2 ** (count + 1)) ** 0.5 / (1 - self.b1 ** (count + 1))
        dlr = d * lr * bc
        terms = [torch.sum(g * (p0 - p)) for g, p0, p in zip(grads, state["params0"], params)]
        numerator = sum(terms) if zero is None else zero.total(terms)
        s_coef = d if self.safeguard_warmup else dlr
        for g, ea, eas, gs in zip(grads, state["exp_avg"], state["exp_avg_sq"],
                                  state["grad_sum"]):
            dg = d * g
            ea.mul_(self.b1).add_(dg, alpha=1 - self.b1)
            eas.mul_(self.b2).addcmul_(dg, dg, value=1 - self.b2)
            gs.mul_(self.b3).add_(s_coef * dg / self.D0)
        state["numerator_weighted"] = (self.b3 * state["numerator_weighted"]
                                       + (d / self.D0) * dlr * numerator)
        terms = [gs.abs().sum() for gs in state["grad_sum"]]
        denominator = sum(terms) if zero is None else zero.total(terms)
        state["estim_lr"] = torch.maximum(
            d, self.D_COEF * state["numerator_weighted"] / denominator)
        for p, ea, eas in zip(params, state["exp_avg"], state["exp_avg_sq"]):
            p.add_(-self.weight_decay * dlr * p - dlr * ea / (torch.sqrt(eas) + d * self.eps))


class Optimizer:
    """global-norm clip -> update rule -> learning rate, optionally behind
    k-step accumulation. `init(params, names)` makes the state (a dict of
    numbers, tensors and lists, so it saves with torch.save; `names`, the
    parameters' state-dict names, tell Adafactor which tensors the JAX package
    holds as one stacked leaf);
    `update_(params, grads, state)` updates the parameters in place and
    returns the state. The schedule is read at the count before the step."""

    def __init__(self, rule, lr, *, max_grad_norm, accumulate_steps):
        self.rule = rule
        self.lr = lr if callable(lr) else (lambda step, _lr=float(lr): _lr)
        self.max_grad_norm = max_grad_norm
        self.accumulate_steps = int(accumulate_steps)
        self.zero: Optional[Zero] = None

    def init(self, params: List[torch.Tensor], names: Optional[List[str]] = None,
             zero: Optional[Zero] = None) -> Dict:
        """`zero`: the ZeRO-2 layout of `params` (then the state holds this
        rank's part, and `update_` takes and updates the full lists)."""
        self.zero = zero
        if zero is not None:
            params, names = zero.take(params), zero.local_names()
        state = {"count": 0, **self.rule.init(params, names, zero)}
        if self.accumulate_steps > 1:
            state.update(mini_step=0, acc=[torch.zeros_like(p) for p in params])
        return state

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict) -> Dict:
        zero, full = self.zero, params
        if zero is not None:
            params, grads = zero.take(params), zero.take(grads)
        if self.accumulate_steps > 1:
            # running mean of the micro-gradients; the chain runs on the k-th
            k = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.add_((g.to(acc.dtype) - acc) / (k + 1))
            state["mini_step"] = (k + 1) % self.accumulate_steps
            if state["mini_step"] != 0:
                return state
            grads = [acc.clone() for acc in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
        else:
            grads = [g.to(p.dtype) for g, p in zip(grads, params)]
        if self.max_grad_norm is not None:
            factor = self.max_grad_norm / torch.clamp(global_norm(grads, zero),
                                                      min=self.max_grad_norm)
            grads = [g * factor.to(g.dtype) for g in grads]
        self.rule.step_(params, grads, state, state["count"], float(self.lr(state["count"])),
                        zero)
        state["count"] += 1
        if zero is not None:
            zero.sync_params(full)
        return state


def make_optimizer(lr=1e-5, *, optimizer: str = "adamw", betas=(0.9, 0.95), eps=1e-8,
                   weight_decay=1e-4, max_grad_norm: Optional[float] = 1.0,
                   prodigy_beta3: Optional[float] = None, prodigy_decouple: bool = True,
                   prodigy_use_bias_correction: bool = False,
                   prodigy_safeguard_warmup: bool = False, accumulate_steps: int = 1,
                   schedule=None) -> Optimizer:
    """Optimizer factory with the reference's get_optimizer surface.

    - adamw (default): lr 1e-5, betas (0.9, 0.95), wd 1e-4, eps 1e-8.
    - adam: no decoupled weight decay.
    - prodigy: the reference passes lr about 1.0 and the beta3 / decouple
      knobs. `prodigy_use_bias_correction` is accepted for flag parity and
      does nothing, as in the JAX package (optax's prodigy has no such knob).
    - adafactor: the JAX package's analog of the reference's 8-bit Adam: a
      factored second moment in place of two full moments. It ignores the Adam
      betas; `weight_decay` is its multiplicative decay rate.

    Global-norm clipping at `max_grad_norm` wraps every choice; with
    `accumulate_steps` it clips the accumulated gradient.
    """
    del prodigy_use_bias_correction
    opt = optimizer.lower()
    if opt in ("adam", "adamw"):
        rule = _Adam(betas, eps, weight_decay if opt == "adamw" else 0.0)
    elif opt == "prodigy":
        rule = _Prodigy(betas, prodigy_beta3, eps, weight_decay if prodigy_decouple else 0.0,
                        prodigy_safeguard_warmup)
    elif opt == "adafactor":
        rule = _Adafactor(weight_decay or 0.0)
    else:
        raise ValueError(f"unsupported optimizer {optimizer!r}: adam|adamw|prodigy|adafactor")
    return Optimizer(rule, schedule if schedule is not None else lr,
                     max_grad_norm=max_grad_norm, accumulate_steps=accumulate_steps)
