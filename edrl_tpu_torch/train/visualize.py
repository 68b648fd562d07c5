"""Plots (``edrl_tpu/train/visualize.py``): the loss and accuracy curves
(the reference's ``loss_plot`` / ``metrics_plot``, ``fusion_train.py:65-76,120-135``)
and the per-epoch Student-t dump of EPRL's proxy distributions
(``fusion_net.py:446-479,852-868``).  matplotlib and scipy are imported when
a plot is drawn, never with the module.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from edrl_tpu_torch.models.auxiliary import estimate_v


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def loss_plot(losses: Sequence[float], path: str) -> str:
    plt = _plt()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.figure()
    plt.plot(range(len(losses)), losses, label="loss")
    plt.legend()
    plt.savefig(path)
    plt.close()
    return path


def metrics_plot(series: dict, path: str) -> str:
    """{name: [values per epoch]} -> one figure with a line per metric."""
    plt = _plt()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.figure()
    for name, values in series.items():
        plt.plot(range(len(values)), values, label=name)
    plt.legend()
    plt.savefig(path)
    plt.close()
    return path


def dump_proxy_distributions(model, model_cfg, epoch: int, out_dir: str) -> Optional[str]:
    """Per-epoch Student-t dump of the EPRL proxies of ``model`` (a MedFusion).

    One subplot per (modality, class): the positive curve is that class's
    EPRL proxy Gaussian summarized as a Student-t (dof from the reference's
    sample-variance estimate), the negative curve pools the other classes.
    ``None`` for a model without EPRL heads.
    """
    z = model_cfg.z_dim
    mu_p, sig_p, v_p, mu_n, sig_n, v_n = [], [], [], [], [], []
    rng = np.random.default_rng(0)
    for name in ("eprl_fundus", "eprl_oct"):
        if not hasattr(model, name):
            continue
        proxies = getattr(model, name).proxies.detach().float().cpu().numpy()  # [C, 2z]
        mu = proxies[:, :z]
        sigma = np.logaddexp(proxies[:, z:], 0.0)  # softplus
        num_classes = proxies.shape[0]

        def stats(rows):
            m = float(mu[rows].mean())
            s = float(sigma[rows].mean())
            samples = mu[rows][None] + sigma[rows][None] * rng.standard_normal(
                (64, len(rows), z)
            ).astype(np.float32)
            v = float(estimate_v(torch.from_numpy(samples.reshape(64, -1)[None])).mean())
            return m, max(s, 1e-4), v

        for c in range(num_classes):
            pos = stats([c])
            neg = stats([k for k in range(num_classes) if k != c] or [c])
            mu_p.append(pos[0]); sig_p.append(pos[1]); v_p.append(pos[2])
            mu_n.append(neg[0]); sig_n.append(neg[1]); v_n.append(neg[2])
    if not mu_p:
        return None
    filename = os.path.join(
        out_dir, f"students_t_distributions_epoch_{epoch}.pdf"
    )
    return visualize_student_t_distributions(
        mu_p, sig_p, v_p, mu_n, sig_n, v_n,
        f"Epoch {epoch} Student's t Distributions (Positive and Negative)",
        filename,
    )


def visualize_student_t_distributions(
    mu_pos, sigma_pos, v_pos, mu_neg, sigma_neg, v_neg, title: str, filename: str
) -> str:
    """Grid of positive/negative Student-t pdfs -> PDF file
    (``fusion_net.py:446-479``)."""
    from scipy.stats import t as student_t

    plt = _plt()
    n = len(mu_pos)
    cols = 4
    rows = (n + cols - 1) // cols
    x = np.linspace(-0.1, 0.1, 1000)
    fig, axes = plt.subplots(rows, cols, figsize=(20, 12), squeeze=False)
    axes = axes.flatten()
    for i in range(n):
        axes[i].plot(
            x,
            student_t.pdf(x, df=v_pos[i], loc=mu_pos[i], scale=sigma_pos[i]),
            label=f"Positive (v={v_pos[i]:.4f})",
            color="blue",
        )
        axes[i].plot(
            x,
            student_t.pdf(x, df=v_neg[i], loc=mu_neg[i], scale=sigma_neg[i]),
            label=f"Negative (v={v_neg[i]:.4f})",
            color="red",
        )
        axes[i].set_title(f"Sample {i + 1}")
        axes[i].legend()
        axes[i].grid(True)
    for i in range(n, rows * cols):
        fig.delaxes(axes[i])
    fig.suptitle(title)
    plt.tight_layout()
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    plt.savefig(filename, format="pdf")
    plt.close(fig)
    return filename
