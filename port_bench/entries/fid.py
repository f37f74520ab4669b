"""Scoring a checkpoint as table 1's FID column does: ``eval/fid.get_fid``
with ``make_inception_features`` (pytorch-fid's InceptionV3 pool3 graph,
batches of ``feature_batch``), ``n_samples`` ancestral samples of the
generator a call against the test statistics, calls one after another.

Set-up draws the generator's weights (uniform in +-1/sqrt(in)) and a
torchvision-layout InceptionV3 state dict (``reference/inception.
random_state_dict``) from the run's seed, makes the extractor from that
state dict as a user with pytorch-fid's file would, and builds the
reference statistics of the 10,000 test images once through the program's
own ``make_mnist_fid_stats`` in a temporary root (the mix's
``val_images`` and ``test_images`` are the split it must take).  It then
reads the extractor's batch counter, ``fn.batches``: a program without it fails
here, before any image.  Each call's generator is seeded from the run's
seed and the call's index.

After the window the path check raises unless the counter grew by a call's
batches for every call and every call ran its extractor inside the
program's ``mcpc.fid.features`` span.  The comparison takes one call drawn
from the seed among those the window finished and holds three numbers:
``image_gap``, its images against the reference's float64 ancestral pass
from the same normals, replayed from the call's generator (worst row);
``feature_gap``, the program's features of three of its batches (the first,
the last and one drawn from the seed) and of the test split's last batch
against the float64 reference network on the same images (worst row: its
largest element gap over its largest reference element); ``fid_gap``, the
returned FID against the reference's float64 moments and distance from the
program's own features of the call and of the test images (relative).
The test images are taken afresh from the data by the mix's split and run
through the program's extractor again, so the statistics the program
cached in set-up are held to the split, the tail batch and the moments
they should have: a fault there moves the returned FID and not the
reference's.
"""

from __future__ import annotations

import contextlib
import random
import tempfile
import types
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.lib import common
from port_bench.lib.common import Number
from port_bench.reference import inception as ref
from port_bench.reference import inception_flops

KIND = "fid"
FEATURES_SPAN = "mcpc.fid.features"
# on an H100, sound runs read at most 2.613e-07, 1.247e-06 and 0 (the same
# float64 form on the same features, 18 seeds); the TF32 control at least
# 2.296e-04, 5.657e-04 and 1.60e-08 (float32 moments).  fid_gap's limit sits
# between that 1.60e-08 and the 2.5e-9 by which a last-bit change of the
# moments can move the FID (the near-zero eigenvalues carry the form's own
# float64 rounding), with room of about 2.5 times on each side
IMAGE_GAP_LIMIT = 1e-5
FEATURE_GAP_LIMIT = 3e-5
FID_GAP_LIMIT = 6e-9


def weights_seed(seed: int) -> int:
    return common.derive(seed, 30)


def call_generator_seed(seed: int, i: int) -> int:
    return common.derive(seed, 31, i)


def ancestral_flops(dims, n: int) -> int:
    """The ancestral pass's matrix-product FLOPs (the first layer's input is
    zero and not counted)."""
    d0, d1, d2, D = dims
    return 2 * n * (d0 * d1 + d1 * d2 + d2 * D)


def replay_normals(seed: int, i: int, n: int, dims) -> tp.List[torch.Tensor]:
    """The standard normals the ancestral pass of call ``i`` draws from its
    generator: each site's [n, d] in order, float32."""
    g = torch.Generator().manual_seed(call_generator_seed(seed, i))
    return [torch.randn((n, d), generator=g) for d in dims[:3]]


class SpanLog:
    """The spans ``get_fid`` opens through its module's ``span``, the open
    ones innermost last; the program's own span is still opened inside."""

    def __init__(self, module):
        self.module, self.original, self.open = module, module.span, []

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.open.append(name)
        try:
            with self.original(name):
                yield
        finally:
            self.open.pop()

    def install(self) -> None:
        self.module.span = self

    def remove(self) -> None:
        self.module.span = self.original


class Scorer:
    """The program's extractor as ``get_fid`` is handed it (its ``tag`` and
    ``device`` with it): notes whether each call ran inside the features
    span, and keeps the images and features of a call it is told to keep."""

    def __init__(self, fn, log: SpanLog):
        self.fn, self.log = fn, log
        self.tag, self.device = fn.tag, fn.device
        self.keep = False
        self.images = self.features = None
        self.spanned: tp.List[bool] = []

    def __call__(self, images: np.ndarray) -> np.ndarray:
        self.spanned.append(FEATURES_SPAN in self.log.open)
        out = self.fn(images)
        if self.keep:
            self.images, self.features = images, out
        return out


def reference_batches(mix) -> int:
    """The extractor's batches over the validation and test images."""
    B = mix["feature_batch"]
    return (len(inception_flops.call_batches(mix["val_images"], B))
            + len(inception_flops.call_batches(mix["test_images"], B)))


def test_images(mix, root: str) -> np.ndarray:
    """The images of the test statistics, [test_images, 28, 28], by the
    mix's split of the data's test set."""
    from montecarlopredictivecoding_tpu_torch.data.mnist import load_mnist_arrays

    _, (te_x, _) = load_mnist_arrays(root)
    v = mix["val_images"]
    return te_x[v : v + mix["test_images"]]


def setup(cell, seed: int, device, span) -> types.SimpleNamespace:
    from montecarlopredictivecoding_tpu_torch.core import trainer
    from montecarlopredictivecoding_tpu_torch.eval import fid, inception

    m = cell.mix
    st = types.SimpleNamespace(cell=cell, seed=seed, device=device, fid=fid)
    st.params = common.make_params(cell.dims, seed, device)
    st.weights = ref.random_state_dict(weights_seed(seed))
    st.fn = inception.make_inception_features(weights=st.weights, batch_size=m["feature_batch"],
                                              device=device)
    before = st.fn.batches  # the program's counter; without it the run stops here
    st.tmp = tempfile.TemporaryDirectory(prefix="port_bench_fid_")
    st.root = st.tmp.name
    fid.make_mnist_fid_stats(st.fn, root=st.root)
    built, want = st.fn.batches - before, reference_batches(m)
    if built != want:
        raise RuntimeError(f"the reference statistics took {built} extractor batches, not {want}")
    st.config = common.port_config(cell.dims)
    st.gen = trainer.GenerativeModel(common.port_model(cell.dims), torch.Generator(),
                                     params=st.params, device=device)
    st.log = SpanLog(fid)
    st.log.install()
    st.scorer = Scorer(st.fn, st.log)
    st.per_call = len(inception_flops.call_batches(m["n_samples"], m["feature_batch"]))
    st.image_flops = inception_flops.image_flops()  # the layer table, outside the window
    st.calls = 0
    st.kept: tp.List[tuple] = []
    st.pick = random.Random(common.derive(seed, 32))
    call(st, span, keep=False)  # warms every shape: the last batch, the moments, eigh
    return st


def call(st, span, keep: bool) -> tuple:
    """One ``get_fid`` call: (its index, its FID, its images and features
    where ``keep``)."""
    m = st.cell.mix
    i = st.calls
    st.scorer.keep = keep
    with span("bench.get_fid"):
        value = st.fid.get_fid(st.gen, st.config, n_samples=m["n_samples"], is_test=m["is_test"],
                               feature_fn=st.scorer, root=st.root,
                               generator=torch.Generator().manual_seed(
                                   call_generator_seed(st.seed, i)))
    st.calls += 1
    if not keep:
        return i, value, None, None
    images, features = st.scorer.images, st.scorer.features
    st.scorer.images = st.scorer.features = None
    return i, value, images, features


def window(st, seconds: float, span) -> types.SimpleNamespace:
    """Calls one after another for ``seconds``; ``check_calls`` of them kept
    by reservoir sampling (whether a call is kept is drawn before it runs)."""
    m = st.cell.mix
    keep = m["check_calls"]
    batches, spanned = st.fn.batches, len(st.scorer.spanned)
    marks = common.Marks(st.device)
    n = 0
    while marks.elapsed() < seconds:
        slot = n if n < keep else st.pick.randrange(n + 1)
        done = call(st, span, keep=slot < keep)
        marks.mark()
        if slot < keep:
            if slot < len(st.kept):
                st.kept[slot] = done
            else:
                st.kept.append(done)
        n += 1
    elapsed = marks.close()
    check_path(st, n, st.fn.batches - batches, st.scorer.spanned[spanned:])
    N = m["n_samples"]
    return types.SimpleNamespace(
        seconds=elapsed, items=n, attempted=n, failed=0,
        end_to_end={"eval_images_per_s": n * N / elapsed},
        flops=n * (N * st.image_flops + ancestral_flops(st.cell.dims, N)),
        feature_batches=n * inception_flops.call_batches(N, m["feature_batch"]))


def check_path(st, n: int, batches: int, spanned: tp.Sequence[bool]) -> None:
    """Raises unless the ``n`` calls ran ``per_call`` extractor batches each,
    every one inside the program's features span."""
    if batches != n * st.per_call:
        raise RuntimeError(f"{n} calls ran {batches} extractor batches, not {n * st.per_call}")
    if len(spanned) != n or not all(spanned):
        raise RuntimeError(f"{spanned.count(False)} of {n} calls ran their features outside "
                           f"{FEATURES_SPAN}")


def release(st) -> None:
    """Put the program's span back and drop what the window made; the
    extractor stays for the comparison."""
    st.log.remove()
    st.gen = st.scorer = None


def last_rows(n: int, B: int) -> range:
    """The rows of the last of the extractor's batches over ``n`` images."""
    return range((n - 1) // B * B, n)


def checked_rows(cell, seed: int, n: int) -> tp.List[range]:
    """The rows of the compared batches: the first, the last and one drawn
    from the seed between them."""
    B = cell.mix["feature_batch"]
    starts = list(range(0, n, B))
    picks = [0, len(starts) - 1]
    if len(starts) > 2:
        picks.insert(1, random.Random(common.derive(seed, 33)).randrange(1, len(starts) - 1))
    return [range(starts[k], min(starts[k] + B, n)) for k in sorted(set(picks))]


def numbers(cell, seed: int, device, weights, params, i: int, value: float,
            images, features, test_x, test_features) -> tp.List[Number]:
    """The three numbers of call ``i`` whose outputs are ``value`` (its FID),
    ``images`` [n, 28, 28] and ``features`` [n, 2048]; ``test_features``
    are the program's features of the test images ``test_x``."""
    n = images.shape[0]
    prog_images = torch.as_tensor(np.asarray(images)).reshape(n, -1).to(device)
    want = ref.ancestral_images(params, replay_normals(seed, i, n, cell.dims))
    image_gap = float(common.row_gaps(prog_images, want).max())

    prog_features = torch.as_tensor(np.asarray(features)).to(device)
    model = ref.build(weights, torch.float64, device)
    feature_gap = 0.0
    for rows in checked_rows(cell, seed, n):
        r = ref.pool3_features(model, prog_images[rows.start : rows.stop])
        got = prog_features[rows.start : rows.stop]
        feature_gap = max(feature_gap, float(common.row_gaps(got, r).max()))
    test_features = torch.as_tensor(np.asarray(test_features)).to(device)
    tail = last_rows(len(test_features), cell.mix["feature_batch"])
    r = ref.pool3_features(model, torch.as_tensor(np.asarray(test_x[tail.start : tail.stop])))
    got = test_features[tail.start : tail.stop]
    feature_gap = max(feature_gap, float(common.row_gaps(got, r).max()))
    del model

    r_fid = ref.frechet_distance(*ref.moments(prog_features), *ref.moments(test_features))
    fid_gap = abs(value - r_fid) / abs(r_fid)
    return [Number("image_gap", image_gap, IMAGE_GAP_LIMIT),
            Number("feature_gap", feature_gap, FEATURE_GAP_LIMIT),
            Number("fid_gap", fid_gap, FID_GAP_LIMIT)]


def check(st) -> tp.List[Number]:
    try:
        test_x = test_images(st.cell.mix, st.root)
        test_features = st.fn(test_x)
        out: tp.List[Number] = []
        for i, value, images, features in st.kept:
            got = numbers(st.cell, st.seed, st.device, st.weights, st.params, i, value, images,
                          features, test_x, test_features)
            out = got if not out else [Number(a.name, max(a.value, b.value), a.limit)
                                       for a, b in zip(out, got)]
        return out
    finally:
        st.fn = None
        st.tmp.cleanup()


def control(cell, seed: int, device, mm=torch.matmul, conv_fn=F.conv2d) -> tp.List[Number]:
    """The reference in float32 with TF32 products and convolutions (on the
    card; ``mm`` and ``conv_fn`` emulate them elsewhere) in the program's
    place for call 0, its moments in float32, held to the float64 reference
    by the same numbers; the test statistics are the float64 moments of its
    features of the test images."""
    m = cell.mix
    N = m["n_samples"]
    weights = ref.random_state_dict(weights_seed(seed))
    params = common.make_params(cell.dims, seed, device)
    images = ref.ancestral_images(params, replay_normals(seed, 0, N, cell.dims), torch.float32,
                                  mm, tf32=True)
    model = ref.build(weights, torch.float32, device, conv_fn)
    features = ref.pool3_features(model, images, m["feature_batch"], tf32=True)
    with tempfile.TemporaryDirectory(prefix="port_bench_fid_") as root:
        test_x = test_images(m, root)
    test_features = ref.pool3_features(model, torch.as_tensor(test_x), m["feature_batch"],
                                       tf32=True)
    del model
    value = ref.frechet_distance(*ref.moments(features, torch.float32),
                                 *ref.moments(test_features))
    return numbers(cell, seed, device, weights, params, 0, value, images.reshape(N, 28, 28).cpu(),
                   features.cpu(), test_x, test_features.cpu())
