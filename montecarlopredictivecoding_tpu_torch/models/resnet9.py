"""ResNet-9, the ideal-observer classifier and FID feature extractor.

The JAX package's ``models/resnet9.py`` as an ``nn.Module`` in NCHW: a
conv block is Conv3x3 (pad 1) -> BatchNorm -> Mish (-> 2x2 max pool); two
residual additions; a final 2x2 max pool, the flatten and a linear head.
``is_mask=True`` is the half-image variant (no pool in conv4, a 768-wide
head) for masked-digit class posteriors.  Module names follow the
reference's torch layout (``conv1.0.weight``, ``res1.0.1.running_var``,
``classifier.weight``), so its state dicts load as they are;
``utils/checkpoint.py`` maps them onto the flax file ``models/resnet9.msgpack``
and back.

The functions are the JAX package's, pure over a :class:`ResNet9State`:
``make_train_step`` returns a step that gives a new state and leaves its
argument as it was, ``make_eval_fn`` the logits, ``make_feature_fn`` the
flattened penultimate map in flax's NHWC order (the FID features).  All run
their convolutions and the head's product in full f32 (``full_f32_conv``):
cuDNN's TF32 default would move the features by about 1e-3 relative.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..core.optim import OptimizerSpec, Transform, apply_updates
from ..utils.precision import full_f32_conv


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x·tanh(softplus(x))``.  ``F.softplus`` returns x above 20, where
    the exact value exceeds it by under 2.1e-9 (1e-10 relative); tanh of
    either is 1.0 in f32, so mish loses nothing to it."""
    return x * torch.tanh(F.softplus(x))


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channels of an NCHW map, written out
    rather than ``nn.BatchNorm2d``: in training flax normalises by the biased
    batch variance ``E[x²] - E[x]²`` (clipped at 0) and moves the running
    variance toward that biased value, at momentum 0.99 (torch's 0.01),
    where ``nn.BatchNorm2d`` moves it toward the unbiased one.  eps is 1e-5
    in both.  ``num_batches_tracked`` is kept for the reference's layout."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]


def conv_block(c_in: int, c_out: int, pool: bool = False) -> nn.Sequential:
    layers = [nn.Conv2d(c_in, c_out, 3, padding=1), BatchNorm(c_out), Mish()]
    if pool:
        layers.append(nn.MaxPool2d(2))  # VALID, as flax's: 7 -> 3
    return nn.Sequential(*layers)


def _feats_hw(input_hw, is_mask: bool) -> tp.Tuple[int, int]:
    """The map's spatial shape before the flatten: three pools (two for the
    masked variant) and the final one, each halving with the floor."""
    h, w = input_hw
    for _ in range(3 if is_mask else 4):
        h, w = h // 2, w // 2
    return h, w


class ResNet9(nn.Module):
    def __init__(self, num_classes: int = 10, is_mask: bool = False, input_hw=None):
        super().__init__()
        if input_hw is None:
            input_hw = (14, 28) if is_mask else (28, 28)
        self.is_mask = is_mask
        self.conv1 = conv_block(1, 64)
        self.conv2 = conv_block(64, 128, pool=True)
        self.res1 = nn.Sequential(conv_block(128, 128), conv_block(128, 128))
        self.conv3 = conv_block(128, 256, pool=True)
        self.conv4 = conv_block(256, 256, pool=not is_mask)
        self.res2 = nn.Sequential(conv_block(256, 256), conv_block(256, 256))
        h, w = _feats_hw(input_hw, is_mask)
        self.classifier = nn.Linear(256 * h * w, num_classes)

    def forward(self, x, return_features: bool = False):
        """``x`` ``[B, 1, H, W]``.  Logits, and with ``return_features`` the
        features ``[B, h*w*256]`` in flax's NHWC flatten order too."""
        x = self.conv2(self.conv1(x))
        x = self.res1(x) + x
        x = self.conv4(self.conv3(x))
        x = self.res2(x) + x
        x = F.max_pool2d(x, 2)
        logits = self.classifier(x.flatten(1))
        if return_features:
            return logits, x.permute(0, 2, 3, 1).flatten(1)
        return logits


class ResNet9State(tp.NamedTuple):
    params: tp.Dict[str, torch.Tensor]
    batch_stats: tp.Dict[str, torch.Tensor]
    opt_state: tp.Any


def state_from_module(model: ResNet9, tx: tp.Optional[Transform] = None) -> ResNet9State:
    """The module's parameters and buffers, copied, as a state (with ``tx``'s
    initial optimizer state)."""
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats = {k: v.detach().clone() for k, v in model.named_buffers()}
    return ResNet9State(params, stats, None if tx is None else tx.init(params))


def _lecun_normal_(w: torch.Tensor, generator) -> None:
    """flax's default kernel init: a normal truncated at ±2 standard
    deviations, variance 1/fan_in after the truncation."""
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_resnet9(generator: tp.Optional[torch.Generator] = None, is_mask: bool = False,
                 lr: float = 1e-3, input_hw=None, device="cuda"):
    """``(model, tx, state)``: a fresh ResNet-9 on ``device`` with flax's
    initialisation (lecun-normal kernels, zero biases) drawn from
    ``generator``, Adam at ``lr`` and its state.  ``input_hw`` None is the
    shape the variant consumes: 28x28, or the 14x28 bottom half."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = ResNet9(is_mask=is_mask, input_hw=input_hw)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, generator)
                m.bias.zero_()
    model = model.to(device)
    tx = OptimizerSpec("adam", lr=lr).make()
    return model, tx, state_from_module(model, tx)


def make_train_step(model: ResNet9, tx: Transform):
    """``step(state, images, labels) -> (state', loss, acc)``: one Adam step
    on the mean cross-entropy, the batch statistics in training mode, and
    the running statistics moved as flax moves them."""

    def step(state: ResNet9State, images, labels):
        stats = {k: v.clone() for k, v in state.batch_stats.items()}
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        model.train()
        with torch.enable_grad(), full_f32_conv():
            # functional_call writes the running statistics into ``stats``
            logits = functional_call(model, {**leaves, **stats}, (images,))
            loss = F.cross_entropy(logits, labels)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            grads = dict(zip(leaves, grads))
            updates, opt_state = tx.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
            acc = (logits.argmax(-1) == labels).float().mean()
        return ResNet9State(params, stats, opt_state), loss.detach(), acc

    return step


def _apply(model: ResNet9, state: ResNet9State, images, return_features: bool):
    model.eval()
    with torch.no_grad(), full_f32_conv():
        return functional_call(model, {**state.params, **state.batch_stats}, (images,),
                               {"return_features": return_features})


def make_eval_fn(model: ResNet9):
    """``logits_fn(state, images)``: the logits with the running statistics."""
    return lambda state, images: _apply(model, state, images, False)


def make_feature_fn(model: ResNet9):
    """``feats_fn(state, images)``: the penultimate features (FID's)."""
    return lambda state, images: _apply(model, state, images, True)[1]


def train_resnet9(train_batches, generator: tp.Optional[torch.Generator] = None,
                  epochs: int = 1, is_mask: bool = False, lr: float = 1e-3,
                  log_every: int = 0, device="cuda"):
    """Train the ideal observer on MNIST batches ``([B, 784], labels)``
    (the masked variant on the bottom halves).  Returns ``(model,
    state)``."""
    model, tx, state = init_resnet9(generator, is_mask=is_mask, lr=lr, device=device)
    step = make_train_step(model, tx)
    for _ in range(epochs):
        for i, (images, labels) in enumerate(train_batches):
            x = images.reshape(-1, 1, 28, 28).to(device)
            if is_mask:
                x = x[:, :, 14:, :]
            state, loss, acc = step(state, x, labels.to(device))
            if log_every and i % log_every == 0:
                print(f"step {i}: loss={float(loss):.4f} acc={float(acc):.3f}")
    return model, state


def load_resnet9(path: str = "models/resnet9.msgpack", is_mask: bool = False,
                 device="cuda") -> tp.Tuple[ResNet9, ResNet9State]:
    """``(model, state)`` from a flax ResNet-9 file, no optimizer state."""
    from ..utils.checkpoint import load_resnet9_state_dict

    model = ResNet9(is_mask=is_mask)
    model.load_state_dict(load_resnet9_state_dict(path, is_mask))
    model = model.to(device)
    return model, state_from_module(model)
