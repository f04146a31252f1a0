"""Psychophysics rating analysis (Python port of the study pipeline).

The reference evaluates its illusions with a Prolific/Gorilla study analyzed
in R (illusions_rating/data_analysis/gorilla_analysis.Rmd): attention-check
exclusion (:121-143), per-participant min-max normalization of strength
ratings (:179-199), per-illusion medians, Welch two-sample t-tests against
the control image (:338-350), and a comparison against the model's own
fitness scores (eigen_own_ratings.csv).  This module provides the same
analysis as pandas/scipy functions so the study can be re-run end to end
without R.

Expected tidy ratings format: one row per (participant, illusion) with
columns ``participant_id``, ``illusion_name``, ``strength`` (0-5 Likert).
"""

from __future__ import annotations

from typing import Iterable, Optional

import pandas as pd
from scipy import stats

__all__ = [
    "GALLERY_MODEL_SCORES",
    "attention_check_pass",
    "filter_participants",
    "normalize_per_participant",
    "summarize",
    "welch_tests_vs_control",
    "correlate_with_model_scores",
    "plot_rating_distributions",
    "plot_medians",
]

#: The model's own fitness scores for the published gallery
#: (illusions_rating/gorilla_data/2025/eigen_own_ratings.csv) — the quality
#: baseline the rebuild is compared against (BASELINE.md).
GALLERY_MODEL_SCORES = pd.DataFrame(
    [
        (0, "01_bw_rotating", "rotate_01", 0.818),
        (1, "02_bw_rotating", "rotate_01", 0.807),
        (2, "e_fraserwilcox_updated", "0", 0.41),
        (3, "03_bw_shrink", "expand_01", 0.802),
        (4, "04_bw_shrink", "expand_02", 0.817),
        (5, "05_color_shrink", "color_01_expand", 0.804),
        (6, "06_color_shrink", "color_02_expand", 0.815),
        (7, "07_medaka", "manyfish", 0.650),
        (8, "08_control", "control", 0.0),
        (9, "e_rotating-snakes_updated", "0", 0.717),
    ],
    columns=["image_id", "gorilla_name", "file", "score"],
)


def attention_check_pass(
    check_df: pd.DataFrame,
    response_col: str = "Response",
    expected: str = "cat2.jpg",
    participant_col: str = "Participant.External.Session.ID",
) -> pd.Index:
    """Participant ids who answered the attention check correctly
    (gorilla_analysis.Rmd:124-127)."""
    ok = check_df[check_df[response_col] == expected]
    return pd.Index(ok[participant_col].unique())


def filter_participants(
    results: pd.DataFrame, approved: Iterable[str], participant_col: str = "participant_id"
) -> pd.DataFrame:
    """Keep only approved participants (attention-check passers and/or the
    demographics-approved list, gorilla_analysis.Rmd:128-143)."""
    approved = set(approved)
    return results[results[participant_col].isin(approved)].copy()


def normalize_per_participant(
    results: pd.DataFrame,
    strength_col: str = "strength",
    participant_col: str = "participant_id",
) -> pd.DataFrame:
    """Min-max normalize each participant's ratings to [0, 1]
    (gorilla_analysis.Rmd:179-199).  Participants with a zero range keep
    their raw values, as in the reference (the R code skips when r == 0)."""
    out = results.copy()
    out["normalized"] = out[strength_col].astype(float)

    def _norm(g):
        r = g.max() - g.min()
        if r > 0:
            return (g - g.min()) / r
        return g

    out["normalized"] = out.groupby(participant_col)[strength_col].transform(_norm)
    return out


def summarize(
    results: pd.DataFrame,
    illusion_col: str = "illusion_name",
    value_col: str = "normalized",
) -> pd.DataFrame:
    """Per-illusion median / sd / n of (normalized) strength
    (gorilla_analysis.Rmd:263-283)."""
    g = results.groupby(illusion_col)[value_col]
    return pd.DataFrame(
        {"median": g.median(), "sd": g.std(ddof=1), "n": g.count()}
    ).reset_index()


def welch_tests_vs_control(
    results: pd.DataFrame,
    control_name: str,
    illusion_col: str = "illusion_name",
    value_col: str = "strength",
) -> pd.DataFrame:
    """Welch two-sample t-tests of every illusion against the control image
    (gorilla_analysis.Rmd:341-350)."""
    control = results.loc[results[illusion_col] == control_name, value_col]
    rows = []
    for name, g in results.groupby(illusion_col):
        if name == control_name:
            continue
        t, p = stats.ttest_ind(control, g[value_col], equal_var=False)
        rows.append({"illusion_name": name, "t": t, "p_value": p})
    return pd.DataFrame(rows)


def correlate_with_model_scores(
    human_summary: pd.DataFrame,
    model_scores: Optional[pd.DataFrame] = None,
    on: str = "illusion_name",
    model_on: str = "gorilla_name",
    human_col: str = "median",
    model_col: str = "score",
):
    """Merge human medians with the model's own scores and return
    (merged_df, pearson_r, p_value) — the Rmd's "EIGen own evaluation"
    comparison (gorilla_analysis.Rmd:300)."""
    if model_scores is None:
        model_scores = GALLERY_MODEL_SCORES
    merged = human_summary.merge(
        model_scores, left_on=on, right_on=model_on, how="inner"
    )
    r, p = stats.pearsonr(merged[human_col], merged[model_col])
    return merged, float(r), float(p)


def plot_rating_distributions(
    results: pd.DataFrame,
    path: str,
    illusion_col: str = "illusion_name",
    value_col: str = "normalized",
    bins: int = 10,
):
    """Per-illusion histograms of (normalized) strength ratings — the Rmd's
    figure pages (gorilla_analysis.Rmd:200-260).  Saves a PNG grid and
    returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = sorted(results[illusion_col].unique())
    cols = 3
    rows = -(-len(names) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 2.6 * rows),
                             squeeze=False)
    for ax in axes.ravel():
        ax.set_visible(False)
    for i, name in enumerate(names):
        ax = axes[i // cols][i % cols]
        ax.set_visible(True)
        sub = results.loc[results[illusion_col] == name, value_col]
        ax.hist(sub, bins=bins, range=(0, 1), color="#4878a8")
        ax.set_title(str(name), fontsize=9)
        ax.set_xlim(0, 1)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_medians(
    summary: pd.DataFrame,
    path: str,
    illusion_col: str = "illusion_name",
):
    """Median strength per illusion with sd error bars — the Rmd's
    "Median of normalized values, with errors" figure (:311)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s = summary.sort_values("median")
    fig, ax = plt.subplots(figsize=(1.0 + 0.8 * len(s), 3.2))
    ax.bar(s[illusion_col], s["median"], yerr=s["sd"].fillna(0.0),
           color="#4878a8", capsize=3)
    ax.set_ylabel("median normalized strength")
    ax.tick_params(axis="x", rotation=45, labelsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
