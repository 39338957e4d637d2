"""FID, KID, Inception Score and PRDC, counterpart of `locate_tpu/io/fid.py`.

The metrics are the JAX package's numpy code, copied as it is and kept in
f64 on the host: Frechet distance (scipy's `sqrtm`, imported when it is
called), KID's unbiased polynomial-kernel MMD^2 over `default_rng(seed)`
subsets, Inception Score from class logits, and precision / recall /
density / coverage from kNN radii. Stats files are pytorch-fid's (`mu`,
`sigma` keys), so they pass between both packages and pytorch-fid.

Feature extractors (uint8 NHWC in, (N, D) f32 numpy out), each on a
device of its own, in f32 with TF32 off for cuDNN and matmul inside the
call (a feature net at TF32 would move the score between devices):

  * `RandomConvFeatures` — the default ("rFID"): four stride-2 3x3 convs
    with JAX's weights, drawn by `utils/jax_random.py` bit for bit, and
    JAX's SAME padding, so its features equal the JAX package's. A valid
    relative metric, not comparable to published Inception-FID;
  * `NpzFeatureExtractor` — an `.npz` of conv weights (`w0..wK`), or the
    InceptionV3 pool3 graph of `io/inception.py` when the archive has
    its `format` (true FID once converted weights are in place).

`evaluate_generator` keeps the JAX function's contract, and its draws:
the fake latents of the batch at offset i are `normal(fold_in(
prng_key(seed), i))`, so a JAX checkpoint carried across scores the same
rFID in both packages. The eval draws nothing from any `torch.Generator`.

The eval runs over a mesh (`parallel/mesh.py`; one process's mesh by
default): each batch of latents (drawn whole on every rank) and of real
images is padded to a multiple of the world by repeating its leading rows
and each rank generates and extracts its rows (the JAX `_shard_batch`'s
pad-and-trim); the features are all-gathered, and rank 0 computes the
scores once and hands them to every rank. One process's mesh has no
collectives: its rows are the whole batch and it gathers nothing.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from locate_tpu_torch.device import resolve_device
from locate_tpu_torch.parallel.mesh import Mesh
from locate_tpu_torch.utils import jax_random as jr

Images = Union[np.ndarray, torch.Tensor]
FeatureFn = Callable[[Images], np.ndarray]  # uint8 NHWC -> (N, D) f32


# ---------------------------------------------------------------------------
# statistics (the JAX package's numpy code)
# ---------------------------------------------------------------------------


def feature_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an (N, D) feature matrix."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def save_stats(path: str, mu: np.ndarray, sigma: np.ndarray, **extra) -> None:
    """(mu, sigma) as an .npz with pytorch-fid's `--save-stats` keys."""
    np.savez(path, mu=np.asarray(mu, np.float64),
             sigma=np.atleast_2d(np.asarray(sigma, np.float64)), **extra)


def load_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) from an .npz of `save_stats`, `locate-tpu eval
    --stats-out` or pytorch-fid: reference statistics computed elsewhere
    stand in for the real images."""
    data = np.load(path)
    keys = set(data.files)
    if not {"mu", "sigma"} <= keys:
        raise ValueError(
            f"{path!r} is not a stats archive (need keys mu+sigma, "
            f"got {sorted(keys)})"
        )
    return np.asarray(data["mu"], np.float64), np.atleast_2d(
        np.asarray(data["sigma"], np.float64)
    )


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID = |mu1-mu2|^2 + Tr(s1 + s2 - 2 sqrtm(s1 s2))."""
    from scipy import linalg

    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))

    def _sqrtm(a):
        out = linalg.sqrtm(a)
        # scipy < 1.17 returns (sqrtm, errest) with disp=False; >= 1.17 the array
        return out[0] if isinstance(out, tuple) else out

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        # regularize near-singular covariances
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    covmean = np.real(covmean)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def kid(features_a: np.ndarray, features_b: np.ndarray, subset_size: int = 512,
        n_subsets: int = 10, seed: int = 0) -> float:
    """Unbiased polynomial-kernel MMD^2 (k(x,y) = (x.y/D + 1)^3), averaged
    over random subsets (the standard KID estimator)."""
    a = np.asarray(features_a, np.float64)
    b = np.asarray(features_b, np.float64)
    d = a.shape[1]
    rng = np.random.default_rng(seed)
    m = min(subset_size, len(a), len(b))
    if m < 2:
        raise ValueError(f"KID needs >= 2 samples per side, got {m}")
    vals = []
    for _ in range(n_subsets):
        xa = a[rng.choice(len(a), m, replace=False)]
        xb = b[rng.choice(len(b), m, replace=False)]
        kaa = (xa @ xa.T / d + 1.0) ** 3
        kbb = (xb @ xb.T / d + 1.0) ** 3
        kab = (xa @ xb.T / d + 1.0) ** 3
        np.fill_diagonal(kaa, 0.0)
        np.fill_diagonal(kbb, 0.0)
        mmd = (
            kaa.sum() / (m * (m - 1))
            + kbb.sum() / (m * (m - 1))
            - 2.0 * kab.mean()
        )
        vals.append(mmd)
    return float(np.mean(vals))


def inception_score(logits: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """Inception Score (arXiv 1606.03498 §4) from class logits: exp(E_x
    KL(p(y|x) || p(y))) per split, p(y) the split's marginal; (mean, std)
    over the splits."""
    z = np.asarray(logits, np.float64)
    if z.ndim != 2 or len(z) < splits:
        raise ValueError(f"need (N>= {splits}, n_classes) logits, got {z.shape}")
    z = z - z.max(axis=1, keepdims=True)  # stable softmax
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    scores = []
    for chunk in np.array_split(p, splits):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + 1e-16) - np.log(marginal + 1e-16))).sum(1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def _pairwise_dist(a: np.ndarray, b: np.ndarray, batch: int = 4096) -> np.ndarray:
    """Euclidean distance matrix [len(a), len(b)] in f64, row-batched."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    bb = (b * b).sum(1)
    rows = []
    for i in range(0, len(a), batch):
        ai = a[i : i + batch]
        sq = (ai * ai).sum(1)[:, None] + bb[None, :] - 2.0 * ai @ b.T
        rows.append(np.sqrt(np.maximum(sq, 0.0)))
    return np.concatenate(rows, axis=0)


def _knn_radius(x: np.ndarray, k: int) -> np.ndarray:
    """Distance from each point to its k-th nearest OTHER point in x."""
    d = _pairwise_dist(x, x)
    np.fill_diagonal(d, np.inf)
    return np.partition(d, k - 1, axis=1)[:, k - 1]


def prdc(real_features: np.ndarray, fake_features: np.ndarray,
         k: int = 5) -> dict:
    """Improved precision/recall (arXiv 1904.06991) and density/coverage
    (arXiv 2002.09797) from kNN manifold estimates: precision and density
    measure fidelity, recall and coverage diversity."""
    real = np.asarray(real_features, np.float64)
    fake = np.asarray(fake_features, np.float64)
    if min(len(real), len(fake)) <= k:
        raise ValueError(f"prdc needs > k={k} samples per side, got "
                         f"{len(real)} real / {len(fake)} fake")
    r_real = _knn_radius(real, k)   # [Nr]
    r_fake = _knn_radius(fake, k)   # [Nf]
    d_rf = _pairwise_dist(real, fake)  # [Nr, Nf]
    in_real = d_rf <= r_real[:, None]  # fake j inside real i's ball
    return {
        "precision": float(in_real.any(axis=0).mean()),
        "recall": float((d_rf <= r_fake[None, :]).any(axis=1).mean()),
        "density": float(in_real.sum(axis=0).mean() / k),
        "coverage": float((d_rf.min(axis=1) <= r_real).mean()),
    }


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN convolutions and matmuls inside the block (the
    settings are restored after it)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def images_nchw(images_u8: Images, device: torch.device) -> torch.Tensor:
    """uint8 NHWC (numpy or tensor) -> f32 NCHW on `device`, unscaled."""
    x = images_u8 if isinstance(images_u8, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(images_u8))
    return x.to(device).permute(0, 3, 1, 2).float()


def same_padding(size: int, kernel: int = 3, stride: int = 2) -> Tuple[int, int]:
    """JAX's "SAME" padding (before, after) of one spatial axis: the total
    that gives ceil(size / stride) outputs, the odd element after, so
    (0, 1) for an even size at 3x3 / 2 and (1, 1) for an odd one."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """A stride-`stride` conv with JAX's SAME padding (OIHW weights)."""
    top, bottom = same_padding(x.shape[2], w.shape[2], stride)
    left, right = same_padding(x.shape[3], w.shape[3], stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def conv_stack(ws, x_u8: Images, device: torch.device, tail) -> np.ndarray:
    """The extractors' core: uint8 -> [-1, 1], then stride-2 SAME convs
    with leaky_relu 0.2; `tail(i, n_layers, x, feats)` pools."""
    with torch.inference_mode(), exact_f32():
        x = images_nchw(x_u8, device) / 127.5 - 1.0
        feats = []
        for i, w in enumerate(ws):
            x = F.leaky_relu(conv_same(x, w), 0.2)
            feats = tail(i, len(ws), x, feats)
        return torch.cat(feats, dim=1).cpu().numpy().astype(np.float32, copy=False)


def random_conv_weights(seed: int, width: int, cin: int):
    """RandomConvFeatures' HWIO weights as numpy, JAX's draws:
    normal(split(PRNGKey(seed), 4)[i], (3, 3, ci, co)) * sqrt(2/(9 ci))."""
    chans = [cin, width, width * 2, width * 4, width * 4]
    keys = jr.split(jr.prng_key(seed), len(chans) - 1)
    return [jr.normal(k, (3, 3, ci, co)) * np.float32(np.sqrt(2.0 / (9 * ci)))
            for k, ci, co in zip(keys, chans[:-1], chans[1:])]


def hwio_to_oihw(w: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1))).to(device)


class RandomConvFeatures:
    """Deterministic random-weight conv features: four stride-2 3x3 convs
    (leaky_relu 0.2) and the mean and population std over H, W of the last
    two stages, 16 * width features. The weights depend on (seed, width,
    input channels) only, not on the resolution."""

    def __init__(self, seed: int = 0, width: int = 64, device=None):
        self.seed = seed
        self.width = width
        self.device = resolve_device(device)
        self._weights = {}  # by input channel count

    @property
    def cache_token(self) -> str:
        return f"random_conv:{self.seed}:{self.width}"

    def weights(self, cin: int):
        if cin not in self._weights:
            self._weights[cin] = [hwio_to_oihw(w, self.device) for w in
                                  random_conv_weights(self.seed, self.width, cin)]
        return self._weights[cin]

    @staticmethod
    def _tail(i, n_layers, x, feats):
        if i >= n_layers - 2:
            feats = feats + [x.mean(dim=(2, 3)), x.std(dim=(2, 3), correction=0)]
        return feats

    def __call__(self, images_u8: Images) -> np.ndarray:
        return conv_stack(self.weights(images_u8.shape[-1]), images_u8, self.device,
                          self._tail)


class NpzFeatureExtractor:
    """The `--extractor=PATH.npz` slot. An archive with a `format` field
    is the InceptionV3 pool3 graph (`io/inception.py`; its classifier head,
    when the archive has one, is `.fc`); any other is a stack of HWIO conv
    kernels `w0..wK` (stride 2 each, applied as in RandomConvFeatures),
    pooled by the mean of its last stage."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.device = resolve_device(device)
        data = np.load(path)
        if "format" in data.files:
            from locate_tpu_torch.io.inception import FORMAT, InceptionExtractor

            fmt = str(data["format"])
            if fmt != FORMAT:
                raise ValueError(f"unknown extractor format {fmt!r} in {path!r}")
            self._inner = InceptionExtractor(path, device=self.device)
            self._call = self._inner
            self._token = self._inner.cache_token
            self.fc = self._inner.fc  # classifier head (Inception Score)
            return
        ws = [hwio_to_oihw(data[f"w{i}"], self.device) for i in range(len(data.files))]

        def tail(i, n_layers, x, feats):
            return [x.mean(dim=(2, 3))] if i == n_layers - 1 else feats

        self._call = lambda images: conv_stack(ws, images, self.device, tail)
        self._token = f"npz:{self.path}"

    @property
    def cache_token(self) -> str:
        return self._token

    def __call__(self, images_u8: Images) -> np.ndarray:
        return self._call(images_u8)


# ---------------------------------------------------------------------------
# end-to-end evaluation
# ---------------------------------------------------------------------------


def features_in_batches(images_u8: Images, extractor: FeatureFn, batch: int = 64,
                        mesh: Optional[Mesh] = None,
                        device: Optional[torch.device] = None) -> np.ndarray:
    """The extractor's features of `images_u8`, `batch` images a call; with
    `mesh`, each batch's rows split over its ranks (`rank_rows`),
    extracted where they lie, all-gathered on `device` and trimmed."""
    mesh = mesh or Mesh()
    outs = []
    for i in range(0, len(images_u8), batch):
        chunk = images_u8[i : i + batch]
        outs.append(gather_rows(extractor(rank_rows(chunk, mesh)), len(chunk), mesh, device))
    return np.concatenate(outs, axis=0)


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def generate_from_key(model: torch.nn.Module, key: np.ndarray, count: int,
                      labels: Optional[torch.Tensor] = None,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """uint8 NHWC images on the model's device from the JAX package's
    latents `normal(key, (count, latent_dim))`, drawn on the host; labels
    arange(count) % num_classes for a conditional model (`locate_tpu/io/
    sampling.py:generate_samples`). With `mesh`, this rank's rows of them
    (`rank_rows`)."""
    from locate_tpu_torch.io.sampling import to_uint8_tensor

    cfg = model.config
    device = model_device(model)
    z = torch.from_numpy(jr.normal(key, (count, cfg.latent_dim))).to(device)
    if labels is None and cfg.num_classes:
        labels = torch.arange(count, device=device) % cfg.num_classes
    if mesh is not None:
        z = rank_rows(z, mesh)
        labels = None if labels is None else rank_rows(labels, mesh)
    with torch.inference_mode():
        return to_uint8_tensor(model(z, labels))


def _pad_rows(x, m: int):
    """`x` (numpy or tensor) with its leading rows repeated up to m rows."""
    n = len(x)
    if m == n:
        return x
    reps = -(-(m - n) // n)
    if isinstance(x, torch.Tensor):
        return torch.cat([x] + [x] * reps)[:m]
    return np.concatenate([x] + [x] * reps)[:m]


def rank_rows(x, mesh):
    """This rank's rows of a batch padded to a multiple of the mesh's data
    axis (`_pad_rows`); the model ranks of a data row take the same rows."""
    per = -(-len(x) // mesh.dp)
    i = mesh.data_index
    return _pad_rows(x, per * mesh.dp)[i * per:(i + 1) * per]


def gather_rows(features: np.ndarray, n: int, mesh: Mesh, device: torch.device) -> np.ndarray:
    """Every data rank's rows of a padded batch (`rank_rows`), in order, trimmed
    to its n rows: the all-gather runs on `device` (one process's rows
    are the batch, returned as they are)."""
    if mesh.group is None:
        return features[:n]
    t = torch.from_numpy(np.ascontiguousarray(features)).to(device)
    return mesh.all_gather(t).cpu().numpy()[:n]


def generate_fakes(model: torch.nn.Module, n_samples: int, batch: int, seed: int,
                   label: Optional[int] = None, mesh: Optional[Mesh] = None):
    """The eval's fake batches: offset i draws from fold_in(prng_key(seed),
    i) (`evaluate_generator`'s and `swd_generator`'s key scheme); with
    `mesh`, this rank's rows of each (`generate_from_key`)."""
    key = jr.prng_key(seed)
    device = model_device(model)
    for i in range(0, n_samples, batch):
        n = min(batch, n_samples - i)
        labels = None if label is None else torch.full((n,), label, device=device)
        yield generate_from_key(model, jr.fold_in(key, i), n, labels, mesh)


def real_examples(dataset, n_samples: int, seed: int, label: Optional[int] = None) -> np.ndarray:
    """min(n_samples, pool) dataset images, uint8 NHWC: the JAX eval's
    draw `default_rng(seed).choice` without replacement over the dataset
    (or over its examples of class `label`)."""
    rng = np.random.default_rng(seed)
    pool = np.arange(len(dataset))
    if label is not None:
        ds_labels = getattr(dataset, "labels", None)
        if ds_labels is None:
            raise ValueError(
                "per-class eval needs a dataset with a .labels array "
                f"({type(dataset).__name__} has none)"
            )
        pool = pool[np.asarray(ds_labels) == label]
        if len(pool) == 0:
            raise ValueError(f"dataset has no examples of class {label}")
    idx = rng.choice(pool, min(n_samples, len(pool)), replace=False)
    return np.stack([dataset.example(int(i))[0] for i in idx])


class _Clock:
    """Seconds a phase of the eval takes, the device's queue drained at
    each reading (nothing is recorded without a `seconds` dict)."""

    def __init__(self, seconds: Optional[dict], device: torch.device):
        self.seconds, self.device = seconds, device
        self.t = self._now()

    def _now(self) -> float:
        if self.seconds is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        if self.seconds is not None:
            t = self._now()
            self.seconds[name] = self.seconds.get(name, 0.0) + t - self.t
            self.t = t


def evaluate_generator(
    model: torch.nn.Module,
    dataset=None,
    *,
    n_samples: int = 1024,
    extractor: Optional[FeatureFn] = None,
    batch: int = 64,
    seed: int = 0,
    cache: Optional[dict] = None,
    ref_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    out: Optional[dict] = None,
    prdc_k: Optional[int] = None,
    label: Optional[int] = None,
    is_splits: Optional[int] = None,
    seconds: Optional[dict] = None,
    mesh: Optional[Mesh] = None,
) -> dict:
    """Generate n_samples with `model` (a serving generator), extract
    features of them and of as many dataset examples, and return {"fid",
    "kid", "n_fake", "n_real"} (rFID / rKID with the default extractor,
    which runs on the model's device).

    `cache` (one dict across calls, as the in-training eval passes) keeps
    the real features, keyed by (dataset, extractor's `cache_token`,
    seed, n_samples, label). `ref_stats=(mu, sigma)` replaces the real
    side (no dataset needed; KID is then None). `out` receives the raw
    arrays: `fake_features`, `fake_mu`, `fake_sigma`, and with a real
    side `real_features`, `real_mu`, `real_sigma`. `prdc_k` adds
    precision / recall / density / coverage (not with ref_stats). `label`
    holds both sides to one class. `is_splits` adds the Inception Score
    of the fakes through the extractor's classifier head `.fc`.
    `seconds` receives the time of generation, feature extraction, the
    real images' reading and the metrics ("generate", "features", "data",
    "metrics"). `mesh` (a process group's, `parallel/mesh.py`; one
    process's by default) splits generation and feature extraction over
    its ranks, every rank calling this; the scores, computed on rank 0,
    are every rank's result."""
    device = model_device(model)
    extractor = extractor or RandomConvFeatures(device=device)
    clock = _Clock(seconds, device)
    mesh = mesh or Mesh()
    fake_feats = []
    for i, imgs in zip(range(0, n_samples, batch),
                       generate_fakes(model, n_samples, batch, seed, label, mesh)):
        clock.lap("generate")
        fake_feats.append(gather_rows(extractor(imgs), min(batch, n_samples - i), mesh, device))
        clock.lap("features")
    fake = np.concatenate(fake_feats, axis=0)
    result = _scores(fake, dataset, extractor, n_samples, batch, seed, cache, ref_stats, out,
                     prdc_k, label, is_splits, clock, mesh, device)
    return mesh.broadcast_object(result)


def _scores(fake, dataset, extractor, n_samples, batch, seed, cache, ref_stats, out, prdc_k,
            label, is_splits, clock, mesh: Mesh, device) -> Optional[dict]:
    """`evaluate_generator`'s scores from the fake features: the real
    features split over the mesh's ranks, the scores on rank 0 only (None
    elsewhere)."""
    primary = mesh.primary
    mu_f, s_f = feature_stats(fake)
    if out is not None:
        out.update(fake_features=fake, fake_mu=mu_f, fake_sigma=s_f)

    is_result = {}
    if is_splits is not None:
        fc = getattr(extractor, "fc", None)
        if fc is None:
            raise ValueError(
                "Inception Score needs an extractor with a classifier head "
                "(.fc) — pass an InceptionExtractor whose .npz includes "
                "fc.w/fc.b (scripts/convert_inception.py ships it)"
            )
        w, b = fc
        if primary:
            is_mean, is_std = inception_score(fake @ w + b, splits=is_splits)
            is_result = {"is_mean": is_mean, "is_std": is_std}

    if ref_stats is not None:
        if prdc_k is not None:
            raise ValueError(
                "prdc needs per-sample real features; ref_stats mode only "
                "has (mu, sigma) — pass a dataset (or precomputed features) "
                "instead"
            )
        if not primary:
            return None
        mu_r, s_r = ref_stats
        result = {
            "fid": frechet_distance(mu_f, s_f, mu_r, s_r),
            "kid": None,  # MMD needs per-sample features, not stats
            "n_fake": len(fake),
            "n_real": None,
            "real_side": "ref_stats",
            **is_result,  # IS is fake-side only
        }
        clock.lap("metrics")
        return result

    if dataset is None:
        raise ValueError("evaluate_generator needs a dataset or ref_stats")
    ex_token = getattr(extractor, "cache_token", repr(extractor))
    ds_token = f"{type(dataset).__name__}:{len(dataset)}"
    cache_key = ("real_features", ds_token, ex_token, seed, n_samples, label)
    real = cache.get(cache_key) if cache is not None else None
    if real is None:
        real_imgs = real_examples(dataset, n_samples, seed, label)
        clock.lap("data")
        real = features_in_batches(real_imgs, extractor, batch, mesh, device)
        clock.lap("features")
        if cache is not None:
            cache[cache_key] = real

    mu_r, s_r = feature_stats(real)
    if out is not None:
        out.update(real_features=real, real_mu=mu_r, real_sigma=s_r)
    if not primary:
        return None
    result = {
        "fid": frechet_distance(mu_f, s_f, mu_r, s_r),
        "kid": kid(fake, real),
        "n_fake": len(fake),
        "n_real": len(real),
        **is_result,
    }
    if prdc_k is not None:
        result.update(prdc(real, fake, k=prdc_k))
    clock.lap("metrics")
    return result
