"""The reference's click simulator (the published protocol, written from
its description, not from the program): the mispredicted points are split
into clusters by (ground truth, prediction); a point's boundary distance
is the distance to the nearest valid point of any other cluster (correct
points form one cluster); a cluster's size is its largest distance; the
next click goes to the first point (lowest row) attaining the size of the
cluster chosen, with the ground truth's object. The first round clicks
every cluster, ranked by size (ties by the key 96 gt + 11 pred, ascending)
then shuffled by the caller's ``random.Random``; later rounds click the
top cluster only.

Distances are float32: the three squared differences summed as (x + y) +
z, the square root correctly rounded.
"""

from __future__ import annotations

import torch

_CHUNK = 1 << 26


@torch.no_grad()
def boundary_distances(coords, cluster, query):
    """d[e] for the rows ``query`` [E]: the distance from coords[e] to the
    nearest row of another cluster. coords [N, 3] f32, cluster [N]."""
    n = coords.shape[0]
    rows = max(1, _CHUNK // max(n, 1))
    out = []
    for s in range(0, len(query), rows):
        q = query[s:s + rows]
        c = coords[q]
        d2 = None
        sq = [(c[:, a, None] - coords[None, :, a]) ** 2 for a in range(3)]
        d2 = (sq[0] + sq[1]) + sq[2]
        del sq
        d2 = torch.where(cluster[q][:, None] == cluster[None, :],
                         float("inf"), d2)
        out.append(d2.amin(1))
    d2 = torch.cat(out)
    return torch.sqrt(d2.double()).float()


@torch.no_grad()
def ranked_clusters(pred, labels, coords, max_label: int):
    """[(cluster id, size, first row attaining it)] of the mispredicted
    rows, largest first (ties by the reference key). pred, labels [N] of
    the valid rows."""
    k = max_label + 1
    err = pred != labels
    if not bool(err.any()):
        return []
    cluster = torch.where(err, labels * k + pred, -1)
    rows = torch.nonzero(err)[:, 0]
    d = boundary_distances(coords, cluster, rows)
    cl = cluster[rows]
    out = []
    for c in torch.unique(cl).tolist():
        sel = cl == c
        size = float(d[sel].max())
        first = int(rows[sel][d[sel] == size].min())
        out.append((c, size, first))
    out.sort(key=lambda t: (t[0] // k) * 96 + (t[0] % k) * 11)
    out.sort(key=lambda t: -t[1])      # stable: ties keep the key order
    return out


def first_round(labels, coords, max_label: int, rng):
    """The first round's clicks on the zero prediction: (vox, obj) in
    click order."""
    ranked = ranked_clusters(torch.zeros_like(labels), labels, coords,
                             max_label)
    ranked = list(ranked)
    rng.shuffle(ranked)
    return [(first, int(labels[first])) for _, _, first in ranked]


def next_click(pred, labels, coords, max_label: int):
    """A later round's click: (vox, obj) of the top cluster, or None when
    nothing is wrong."""
    ranked = ranked_clusters(pred, labels, coords, max_label)
    if not ranked:
        return None
    first = ranked[0][2]
    return first, int(labels[first])
