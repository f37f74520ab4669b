"""The plain FID scorer the benchmark holds the port's ``get_fid`` to:
InceptionV3's pool3 features, their moments and the Fréchet distance, and
the ancestral pass of the MCPC generator whose samples they score.

Plain PyTorch, float64 by default and in any dtype on any device, importing
nothing of the program.  The network is written as ``nn.Module``s from
pytorch-fid's ``src/pytorch_fid/inception.py`` (``FIDInceptionA``,
``FIDInceptionC``, ``FIDInceptionE_1``, ``FIDInceptionE_2`` and the pool3
blocks of its ``InceptionV3``) and torchvision's ``models/inception.py``
(``BasicConv2d``: a bias-free convolution, ``BatchNorm2d(eps=0.001)`` in
eval mode and a relu; ``InceptionB``, ``InceptionD``), under torchvision's
state-dict keys (``Mixed_6e.branch7x7dbl_3.conv.weight``, ``...bn.running_var``),
so pytorch-fid's weights file would load here as it loads in the port.

    images [N, 28, 28] in [0, 1] -> grey to RGB -> bilinear resize to
    299 x 299 (half-pixel centres) -> 2x - 1 -> Conv2d_1a .. Conv2d_4a with
    two max pools -> Mixed_5b..5d (A) -> 6a (B) -> 6b..6e (C) -> 7a (D)
    -> 7b (E, average pool) -> 7c (E, max pool) -> global mean: [N, 2048]

The FID variants' average pools leave the zero padding out of the divisor
(``count_include_pad=False``), as TensorFlow's FID graph does; ``Mixed_7c``
pools with a max.  The products run with TF32 off unless a caller asks for
it (the control); the functions set both flags and restore them.

Departures from the published pipeline, each noted:

- The paper's reference code (github.com/gaspardol/MonteCarloPredictiveCoding,
  ``utils/training_evaluation.py:104-139``) writes the samples as PNG files
  that pytorch-fid reads back, so its images are rounded to 8 bits; here,
  as in the port, the float images are scored in process.
- pytorch-fid takes ``scipy.linalg.sqrtm(S1 S2)`` and puts ``eps`` on the
  diagonals only when that fails; here ``eps`` = 1e-6 is always on the
  diagonals, as in the port, and tr sqrtm(S1 S2) is the sum of the square
  roots of the eigenvalues of the symmetric sqrtm(S1) S2 sqrtm(S1), similar
  to S1 S2: the port's form.  The form is not free in float64 at 2048
  features: hundreds of the matrix's eigenvalues lie near zero and their
  square roots carry the rounding of its largest, so another form (Lᵀ S2 L
  with S1 = L Lᵀ) parts from this one by up to 2.5e-9 of the FID, near what
  float32 moments give (1.6e-8 and up); in one form the program's float64
  distance is held to the formula itself.
- The weights are drawn from a seed (:func:`random_state_dict`), not read
  from pytorch-fid's ``pt_inception-2015-12-05`` file, which the repository
  does not hold.
"""

from __future__ import annotations

import contextlib
import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
BN_EPS = 1e-3
SIZE = 299
FEATURES = 2048
FID_EPS = 1e-6


@contextlib.contextmanager
def tf32_flags(on: bool):
    """cuBLAS's and cuDNN's TF32 flags set to ``on`` inside, restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# -- the network -------------------------------------------------------------------


class BasicConv2d(nn.Module):
    """torchvision's BasicConv2d.  ``conv_fn`` computes the convolution
    (``F.conv2d``; the CPU tests' control rounds its operands to TF32)."""

    def __init__(self, c_in: int, c_out: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=BN_EPS)
        self.conv_fn = F.conv2d

    def forward(self, x: Tensor) -> Tensor:
        c = self.conv
        return F.relu(self.bn(self.conv_fn(x, c.weight, None, c.stride, c.padding)))


def avg_pool_excl(x: Tensor) -> Tensor:
    """pytorch-fid's patch: TensorFlow's average pool leaves the padded
    zeros out of the divisor."""
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    """FIDInceptionA."""

    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x: Tensor) -> Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(avg_pool_excl(x))], 1)


class InceptionB(nn.Module):
    """torchvision's InceptionB (pytorch-fid keeps it)."""

    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, kernel_size=3, stride=2)], 1)


class InceptionC(nn.Module):
    """FIDInceptionC."""

    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for k in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{k}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(avg_pool_excl(x))], 1)


class InceptionD(nn.Module):
    """torchvision's InceptionD (pytorch-fid keeps it)."""

    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b7 = x
        for k in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{k}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, kernel_size=3, stride=2)], 1)


class InceptionE(nn.Module):
    """FIDInceptionE_1 (``pool="avg"``, Mixed_7b) and FIDInceptionE_2
    (``pool="max"``, Mixed_7c: TensorFlow's FID graph pools with a max
    there)."""

    def __init__(self, c_in: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "avg":
            bp = avg_pool_excl(x)
        else:
            bp = F.max_pool2d(x, kernel_size=3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class PoolThree(nn.Module):
    """pytorch-fid's InceptionV3 up to its pool3 output (blocks 0 to 3)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: Tensor) -> Tensor:
        """``x`` [N, 3, H, W] in [0, 1] -> [N, 2048]."""
        x = F.interpolate(x, size=(SIZE, SIZE), mode="bilinear", align_corners=False)
        x = 2 * x - 1
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return F.adaptive_avg_pool2d(x, (1, 1)).flatten(1)


def convs(model: nn.Module) -> tp.List[tp.Tuple[str, BasicConv2d]]:
    """The 94 BasicConv2d modules in the order they are declared."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, BasicConv2d)]


def random_state_dict(seed: int) -> tp.Dict[str, Tensor]:
    """A float32 CPU state dict in torchvision's layout, drawn from ``seed``
    layer by layer in declaration order: kernels normal with variance
    2 / fan_in, BatchNorm weight and running variance uniform in [0.5, 1.5),
    bias and running mean normal with standard deviation 0.1 (no BatchNorm
    is the identity, so a skipped one shows)."""
    g = torch.Generator().manual_seed(int(seed))
    model = PoolThree()
    with torch.no_grad():
        for _, m in convs(model):
            w = m.conv.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=g) * math.sqrt(2.0 / fan_in))
            c = w.shape[0]
            m.bn.weight.copy_(0.5 + torch.rand(c, generator=g))
            m.bn.bias.copy_(0.1 * torch.randn(c, generator=g))
            m.bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            m.bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def build(state: tp.Mapping[str, Tensor], dtype=torch.float64, device="cpu",
          conv_fn=F.conv2d) -> PoolThree:
    """The network in eval mode with ``state``'s weights in ``dtype``."""
    model = PoolThree()
    model.load_state_dict(dict(state), strict=True)
    for _, m in convs(model):
        m.conv_fn = conv_fn
    return model.to(device=device, dtype=dtype).eval()


def pool3_features(model: PoolThree, images: Tensor, block: int = 32,
                   tf32: bool = False) -> Tensor:
    """pytorch-fid's pipeline on ``images`` [N, 28, 28] (or [N, 784]) in
    [0, 1]: grey repeated to RGB, the model's dtype and device, ``block``
    images at a time; [N, 2048] in the model's dtype."""
    p = next(model.parameters())
    x = images.reshape(-1, 1, 28, 28)
    out = []
    with torch.no_grad(), tf32_flags(tf32):
        for s in range(0, x.shape[0], block):
            xb = x[s : s + block].to(device=p.device, dtype=p.dtype).repeat(1, 3, 1, 1)
            out.append(model(xb))
    return torch.cat(out)


# -- moments and distance -----------------------------------------------------------


def moments(features: Tensor, dtype=torch.float64) -> tp.Tuple[Tensor, Tensor]:
    """Mean and covariance (N - 1 in the denominator) of [N, d] features,
    computed in ``dtype``."""
    f = features.to(dtype)
    mu = f.mean(0)
    c = f - mu
    with tf32_flags(False):
        return mu, c.T @ c / (f.shape[0] - 1)


def frechet_distance(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor,
                     eps: float = FID_EPS) -> float:
    """||mu1 - mu2||² + tr(S1) + tr(S2) - 2 tr sqrtm(S1 S2) in float64,
    ``eps`` on both diagonals; tr sqrtm(S1 S2) from the eigenvalues of
    R S2 R, R = sqrtm(S1) from S1's eigenvectors (negative rounding of an
    eigenvalue read as zero)."""
    mu1, sigma1, mu2, sigma2 = (t.to(torch.float64) for t in (mu1, sigma1, mu2, sigma2))
    eye = eps * torch.eye(mu1.shape[0], dtype=torch.float64, device=mu1.device)
    s1, s2 = sigma1 + eye, sigma2 + eye
    with tf32_flags(False):
        vals, vecs = torch.linalg.eigh(s1)
        root = (vecs * vals.clamp(min=0.0).sqrt()) @ vecs.T
        lam = torch.linalg.eigvalsh(root @ s2 @ root)
        diff = mu1 - mu2
        return float(diff @ diff + torch.trace(s1) + torch.trace(s2)
                     - 2.0 * lam.clamp(min=0.0).sqrt().sum())


# -- the generator ------------------------------------------------------------------


def ancestral_images(params, normals: tp.Sequence[Tensor], dtype=torch.float64,
                     mm=torch.matmul, tf32: bool = False) -> Tensor:
    """The MCPC generator's Bernoulli means [n, D] from the standard normals
    ``(z0, z1, z2)`` of its three sites, as table 1's FID samples them:

        x0 = b0 + z0;  x1 = relu(x0) W1 + b1 + z1;  x2 = relu(x1) W2 + b2 + z2
        image = sigmoid(relu(x2) W3 + b3)

    (the first layer's input is zero, so it gives its bias); ``params`` are
    the four layers ``{"w": [in, out], "b": [out]}``."""
    (b0,), (w1, b1), (w2, b2), (w3, b3) = (
        tuple(params[i][k].to(dtype) for k in (("b",) if i == 0 else ("w", "b")))
        for i in range(4))
    z0, z1, z2 = (z.to(device=b0.device, dtype=dtype) for z in normals)
    with tf32_flags(tf32):
        x0 = b0 + z0
        x1 = mm(torch.relu(x0), w1) + b1 + z1
        x2 = mm(torch.relu(x1), w2) + b2 + z2
        return torch.sigmoid(mm(torch.relu(x2), w3) + b3)
