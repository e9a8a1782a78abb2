"""Feature extraction and linear probing (port of
``msclip_tpu/eval/linear_probe.py``).

The reference's model-zoo table reports "linear probing" averages over a
24-dataset suite (its ``README.md:24-28``); the probe runner is not in the
release. The protocol is CLIP's: extract frozen ``encode_image`` features,
then fit a linear classifier. Two backends:

* ``probe="sklearn"``: logistic regression (L-BFGS), the CLIP paper's
  protocol, on the host; needs scikit-learn, imported only there;
* ``probe="torch"``: multinomial logistic regression with AdamW on the
  features' device, the counterpart of the JAX package's ``probe="jax"``.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.loader import BatchLoader
from ..data.transforms import dataset_normalizer
from ..models.msclip import MSClipModel, build_spec
from .zero_shot import load_eval_model, resolve_device


@torch.inference_mode()
def extract_features(model: MSClipModel, dataset, batch_size=256, workers=8,
                     normalize=True) -> Tuple[np.ndarray, np.ndarray]:
    """Run the frozen image tower over a dataset -> ``(features [N, E]
    float32, labels)``, on the model's device."""
    device = next(model.buffers()).device
    pre = dataset_normalizer(dataset)
    feats, labels = [], []
    for batch in BatchLoader(dataset, batch_size, workers=workers):
        images = torch.from_numpy(batch["image"]).to(device)
        f = model.encode_image(pre(images), normalize=normalize)
        mask = batch["mask"]
        feats.append(f.float().cpu().numpy()[mask])
        labels.append(np.asarray(batch["label"])[mask])
    return np.concatenate(feats), np.concatenate(labels)


def fit_linear_probe_sklearn(train_x, train_y, test_x, test_y,
                             C: float = 3.16, max_iter: int = 1000,
                             sweep_c: bool = False, seed: int = 0):
    """Logistic-regression probe. With ``sweep_c`` (the CLIP-paper
    protocol, arXiv 2103.00020 A.3): hold out 10% of train as
    validation, run a coarse log-spaced sweep over C in [1e-6, 1e6]
    followed by iterative halving around the peak (~12 fits total),
    then refit on the full train split with the winner."""
    try:
        from sklearn.linear_model import LogisticRegression
    except ImportError as e:
        raise ImportError("the sklearn probe needs scikit-learn, which is "
                          "not installed; pass --probe torch (probe="
                          "'torch') for the probe on the card") from e

    def fit_score(c, x, y, vx, vy):
        clf = LogisticRegression(C=c, max_iter=max_iter, verbose=0)
        clf.fit(x, y)
        return clf.score(vx, vy)

    if sweep_c:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(train_x))
        n_val = max(1, len(order) // 10)
        va, tr = order[:n_val], order[n_val:]
        tx_, ty_ = train_x[tr], train_y[tr]
        vx_, vy_ = train_x[va], train_y[va]
        # coarse grid in log10(C), then 3 halving refinements
        grid = [-6.0, -4.0, -2.0, 0.0, 2.0, 4.0, 6.0]
        scores = {g: fit_score(10.0 ** g, tx_, ty_, vx_, vy_)
                  for g in grid}
        span = 2.0
        for _ in range(3):
            best = max(scores, key=lambda g: (scores[g], -abs(g)))
            span /= 2.0
            for g in (best - span, best + span):
                if g not in scores:
                    scores[g] = fit_score(10.0 ** g, tx_, ty_, vx_, vy_)
        best = max(scores, key=lambda g: (scores[g], -abs(g)))
        C = 10.0 ** best
        logging.info(f"=> C sweep: best C={C:.4g} "
                     f"(val acc {100 * scores[best]:.2f}%, "
                     f"{len(scores)} fits)")

    clf = LogisticRegression(C=C, max_iter=max_iter, verbose=0)
    clf.fit(train_x, train_y)
    return 100.0 * clf.score(test_x, test_y)


def train_linear_probe_torch(train_x, train_y, n_classes: int,
                             epochs: int = 100, lr: float = 1e-3,
                             wd: float = 1e-4, batch_size: int = 1024,
                             seed: int = 0, device="cuda"):
    """The probe's weights ``(w [D, C], b [C])`` on ``device``: zero init,
    AdamW (its decoupled decay is optax ``adamw``'s update), softmax cross
    entropy, ``epochs`` passes over a permutation of the train set drawn
    from ``numpy.random.default_rng(seed)``, the JAX probe's order (the
    same draws are needed for the same weights). As in the JAX probe, the
    ragged remainder of each pass is dropped, and no step runs when
    ``n < batch_size``."""
    x = torch.as_tensor(np.asarray(train_x, np.float32), device=device)
    y = torch.as_tensor(np.asarray(train_y, np.int64), device=device)
    w = torch.zeros(x.shape[1], n_classes, device=device, requires_grad=True)
    b = torch.zeros(n_classes, device=device, requires_grad=True)
    opt = torch.optim.AdamW([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            loss = torch.nn.functional.cross_entropy(x[idx] @ w + b, y[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return w.detach(), b.detach()


def fit_linear_probe_torch(train_x, train_y, test_x, test_y,
                           n_classes: Optional[int] = None, epochs: int = 100,
                           lr: float = 1e-3, wd: float = 1e-4,
                           batch_size: int = 1024, seed: int = 0,
                           device="cuda"):
    """Device-resident multinomial logistic regression; test accuracy in
    percent (``fit_linear_probe_jax``'s counterpart)."""
    device = resolve_device(device)
    n_classes = n_classes or int(np.max(train_y)) + 1
    w, b = train_linear_probe_torch(train_x, train_y, n_classes, epochs=epochs,
                                    lr=lr, wd=wd, batch_size=batch_size,
                                    seed=seed, device=device)
    with torch.no_grad():
        tx = torch.as_tensor(np.asarray(test_x, np.float32), device=device)
        logits = (tx @ w + b).cpu().numpy()
    return 100.0 * (logits.argmax(-1) == np.asarray(test_y)).mean()


def run_linear_probe(config, train_dataset, test_dataset,
                     probe: str = "sklearn", device="cuda", **probe_kw):
    """Full probe: load the model (BN not folded: it runs in eval mode on
    the running statistics, as in the JAX package), extract features for
    both splits, fit."""
    device = resolve_device(device)
    spec = build_spec(config)
    model = load_eval_model(config, spec, device, fold_bn=False, int8=False)
    t0 = time.time()
    kw = dict(batch_size=config.TEST.BATCH_SIZE_PER_GPU,
              workers=config.WORKERS)
    train_x, train_y = extract_features(model, train_dataset, **kw)
    test_x, test_y = extract_features(model, test_dataset, **kw)
    logging.info(f"=> extracted {len(train_x)}+{len(test_x)} features "
                 f"in {time.time() - t0:.1f}s")
    if probe == "sklearn":
        acc = fit_linear_probe_sklearn(train_x, train_y, test_x, test_y,
                                       **probe_kw)
    elif probe == "torch":
        acc = fit_linear_probe_torch(train_x, train_y, test_x, test_y,
                                     device=device, **probe_kw)
    else:
        raise ValueError(f"probe={probe!r}: 'sklearn' or 'torch'")
    logging.info(f"=> linear probe accuracy: {acc:.3f}%")
    return acc
