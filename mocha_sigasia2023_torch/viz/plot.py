"""3D stick-figure animation of (multiple) motion streams.

Counterpart of mocha_sigasia2023_tpu/viz/plot.py (the role of the
reference's etc/viz_motion.py ``animation_plot`` and its variants):
side-by-side skeletons over a checkerboard floor with per-frame foot
contact markers and a root heading ray, FK by the port's quaternion
kinematics on the host.  matplotlib is imported when a plot is made, and
its absence raises an ImportError that names it: the rest of the package
does not need it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kinematics import quat


def _matplotlib():
    try:
        import matplotlib.animation as manimation
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "animation_plot needs the matplotlib package, which is not "
            f"installed here ({e})") from e
    return plt, manimation


def _fk_np(rot, pos, parents):
    gr, gp = quat.fk(torch.as_tensor(np.asarray(rot, np.float32)),
                     torch.as_tensor(np.asarray(pos, np.float32)),
                     np.asarray(parents))
    return gr.numpy(), gp.numpy()


def animation_plot(animations: List[Sequence], *, fps: int = 60,
                   scale_per_anim: float = 0.625, unit_scale: float = 30.0,
                   show_contacts: bool = True, global_space: bool = False,
                   interval_ms: Optional[float] = None, save_path=None,
                   show: bool = True):
    """Animate one or more motions side by side.

    Each animation is ``[pos, rot, contact, foot_indices, parents]`` of
    local pose (T, J, 3/4) — FK is applied here — or, with
    ``global_space=True``, already-global positions.  Entries are offset
    along x so streams render side by side.  Returns the
    ``FuncAnimation``; ``save_path`` (.gif through pillow, .mp4 through
    ffmpeg) writes it.
    """
    plt, manimation = _matplotlib()

    n = len(animations)
    gpos_all, roots_all, contacts_all, feet_all = [], [], [], []
    for anim in animations:
        pos, rot, contact, foot_idx, parents = anim
        if global_space:
            gpos = np.asarray(pos)
            root_dir_pos = gpos[:, 0:1] + np.array([0, 0, 0.5])
        else:
            grot, gpos = _fk_np(rot, pos, parents)
            root_dir = quat.mul_vec(
                torch.from_numpy(grot[:, 0:1]),
                torch.tensor([0.0, 0.0, 1.0])).numpy()
            root_dir_pos = gpos[:, 0:1] + root_dir * 0.5
        gpos_all.append(gpos * unit_scale)
        roots_all.append(root_dir_pos * unit_scale)
        contacts_all.append(np.asarray(contact))
        feet_all.append(np.asarray(foot_idx))

    scale = 1.25 * (n / 2) * unit_scale

    fig = plt.figure(figsize=(12, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlim3d(-scale, scale)
    ax.set_zlim3d(0, scale * 2)
    ax.set_ylim3d(-scale, scale)
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_zticks([])
    ax.view_init(20, -60)

    # checkerboard floor as one pcolormesh-style surface (a per-tile
    # plot_surface loop is prohibitively slow to rasterize)
    tiles = 8
    grid = np.linspace(-scale, scale, tiles + 1)
    gx, gz = np.meshgrid(grid, grid)
    checker = (np.indices((tiles, tiles)).sum(axis=0) % 2).astype(float)
    fc = np.empty((tiles, tiles, 4))
    fc[checker == 0] = (0.85, 0.85, 0.85, 0.25)
    fc[checker == 1] = (0.6, 0.6, 0.6, 0.25)
    ax.plot_surface(gx, gz, np.zeros_like(gx), facecolors=fc,
                    linewidth=0, shade=False, rstride=1, cstride=1)

    T = min(g.shape[0] for g in gpos_all)
    parents_list = [np.asarray(a[4]) for a in animations]
    offsets = [(ai - (n - 1) / 2) * scale * 1.2 for ai in range(n)]
    colors = ["tab:blue", "tab:orange", "tab:green", "tab:red",
              "tab:purple", "tab:brown"]

    bone_lines = []
    contact_dots = []
    heading_lines = []
    for ai in range(n):
        lines = [
            ax.plot([], [], [], color=colors[ai % len(colors)], lw=2)[0]
            for _ in range(len(parents_list[ai]) - 1)
        ]
        bone_lines.append(lines)
        contact_dots.append(ax.plot([], [], [], "o", color="red", ms=5)[0])
        heading_lines.append(
            ax.plot([], [], [], color="black", lw=1)[0])

    def draw(frame):
        artists = []
        for ai in range(n):
            g = gpos_all[ai][frame]
            par = parents_list[ai]
            for li, j in enumerate(range(1, len(par))):
                p = par[j]
                if p < 0:
                    continue
                xs = [g[j, 0] + offsets[ai], g[p, 0] + offsets[ai]]
                ys = [g[j, 2], g[p, 2]]
                zs = [g[j, 1], g[p, 1]]
                bone_lines[ai][li].set_data(xs, ys)
                bone_lines[ai][li].set_3d_properties(zs)
            artists += bone_lines[ai]
            if show_contacts and contacts_all[ai] is not None:
                c = contacts_all[ai][min(frame, len(contacts_all[ai]) - 1)]
                feet = feet_all[ai][np.asarray(c, bool)]
                fp = g[feet] if len(feet) else np.zeros((0, 3))
                contact_dots[ai].set_data(fp[:, 0] + offsets[ai], fp[:, 2])
                contact_dots[ai].set_3d_properties(fp[:, 1])
                artists.append(contact_dots[ai])
            r0 = g[0]
            r1 = roots_all[ai][frame, 0]
            heading_lines[ai].set_data(
                [r0[0] + offsets[ai], r1[0] + offsets[ai]], [r0[2], r1[2]])
            heading_lines[ai].set_3d_properties([r0[1], r1[1]])
            artists.append(heading_lines[ai])
        return artists

    interval = interval_ms if interval_ms is not None else 1000.0 / fps
    ani = manimation.FuncAnimation(
        fig, draw, frames=T, interval=interval, blit=False)
    if save_path:
        ani.save(save_path, fps=fps)
    if show:
        plt.show()
    return ani
