"""File-based training-curve plots: counterpart of ``train/plots.py``, a
copy of it that reads the port's ``MetricHistory``.

The reference's ``VisdomLogger`` (logger.py:13-54) maintains one live line
plot of four series — Training Loss, Validation Loss, Lower Bound,
Discriminative Loss — against epoch, replayed from history on resume
(logger.py:52-54). A Visdom server makes no sense on a headless worker;
this renders the identical figure to ``curves.svg`` inside the experiment
directory after every epoch (atomic replace, so a watcher/browser can poll
it), drawing from the same :class:`~..train.metrics.MetricHistory` that the
JSONL/TensorBoard loggers consume — resume replay is therefore automatic.

Enabled by the reference-parity ``--visdom`` flag (config
``train.plot_curves``). Matplotlib is imported lazily with the Agg backend
and the whole render is best-effort: a plotting failure must never kill a
training run.
"""

from __future__ import annotations

from pathlib import Path

from pytorch_scalablefhvae_tpu_torch.train.metrics import MetricHistory

# (history key, legend label) — legend strings match logger.py:22-27
SERIES = (
    ("train_loss_results", "Training Loss"),
    ("val_loss_results", "Validation Loss"),
    ("lower_bound_results", "Lower Bound"),
    ("discrim_loss_results", "Discriminative Loss"),
)


def write_curves_svg(history: MetricHistory, path: str | Path,
                     run_id: str = "") -> bool:
    """Render the four reference series to ``path`` (SVG). Returns success."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:  # pragma: no cover - matplotlib is in the image
        print(f"curve plot unavailable ({e})")
        return False
    path = Path(path)
    fig = None
    try:
        fig, ax = plt.subplots(figsize=(8, 4.5))
        for key, label in SERIES:
            pts = sorted(history.values[key].items())
            if not pts:
                continue
            ax.plot([ep + 1 for ep, _ in pts], [v for _, v in pts],
                    marker=".", label=label)
        ax.set_xlabel("Epoch")
        ax.set_title(run_id)
        ax.legend(loc="best", fontsize="small")
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        tmp = path.with_suffix(path.suffix + ".tmp")
        fig.savefig(tmp, format="svg")
        tmp.replace(path)  # atomic: watchers never see a half-written file
        return True
    except Exception as e:  # pragma: no cover - best-effort rendering
        print(f"curve plot failed ({e})")
        return False
    finally:
        # close on EVERY path: a persistently failing savefig (full disk)
        # would otherwise leak one registry-held figure per epoch
        if fig is not None:
            plt.close(fig)
