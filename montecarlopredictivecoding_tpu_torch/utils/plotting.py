"""Plotting kit: paper styling, GIF writers, the class-probability
geometry of figure 2 and the trajectory arrows of figure 4.  Importing this
module does not import matplotlib: each function that draws imports it
itself (headless, the Agg backend), so every module of the package imports
where matplotlib is missing."""

from __future__ import annotations

import typing as tp

import numpy as np


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def setup_fig(zero: bool = False, square: bool = True) -> None:
    """The paper's styling of the current figure: font sizes, a 4x4 inch
    figure, one decimal on the ticks unless ``zero``, no top and right
    spines unless ``square``."""
    plt = pyplot()
    from matplotlib import pylab
    from matplotlib.ticker import StrMethodFormatter

    pylab.rcParams.update(
        {
            "legend.fontsize": 14,
            "figure.figsize": (4.0, 4.0),
            "axes.labelsize": 16,
            "axes.titlesize": 18,
            "xtick.labelsize": 14,
            "ytick.labelsize": 14,
        }
    )
    if not zero:
        plt.gca().xaxis.set_major_formatter(StrMethodFormatter("{x:,.1f}"))
        plt.gca().yaxis.set_major_formatter(StrMethodFormatter("{x:,.1f}"))
    if not square:
        ax = plt.gca()
        ax.spines["right"].set_visible(False)
        ax.spines["top"].set_visible(False)


def generate_video(
    imgs: tp.Sequence[np.ndarray],
    show: bool = False,
    save: bool = False,
    title: str = "",
    file_name: str = "movie",
    out_dir: str = "figures",
    fps: int = 50,
) -> None:
    """Write a sequence of grayscale frames as ``<out_dir>/<file_name>.gif``
    (matplotlib's Pillow writer) and/or show it."""
    plt = pyplot()
    import matplotlib.animation as animation
    import matplotlib.cm as cm

    fig = plt.figure()
    plt.title(title)
    plt.axis("off")
    frames = [[plt.imshow(img, animated=True, cmap=cm.Greys_r)] for img in imgs]
    ani = animation.ArtistAnimation(
        fig, frames, interval=max(1000 // fps, 1), blit=True, repeat_delay=1000
    )
    if save:
        ani.save(f"{out_dir}/{file_name}.gif", writer=animation.PillowWriter(fps=fps))
    if show:
        plt.show()
    plt.close(fig)


def animate_frames(
    render_frame: tp.Callable[[int, tp.Any], None],
    n_frames: int,
    path: str,
    fps: int = 50,
    figsize=(4.5, 4.5),
) -> None:
    """A GIF of ``n_frames`` frames at ``path``: ``render_frame(i, ax)`` draws
    frame i onto the given (cleared) axes."""
    plt = pyplot()
    import matplotlib.animation as animation

    fig, ax = plt.subplots(1, 1, constrained_layout=True, figsize=figsize)

    def update(i):
        ax.clear()
        render_frame(i, ax)
        return []

    ani = animation.FuncAnimation(
        fig, update, frames=n_frames, interval=max(1000 // fps, 1), blit=False
    )
    ani.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)


def proba_to_coordinate(probs: np.ndarray):
    """Map class probabilities onto the 10-class polar simplex: returns
    ``((x, y), (class_x, class_y))``."""
    probs = np.atleast_2d(np.asarray(probs))
    class_polar = np.arange(0.0, 10.0) * 2 * np.pi / 10
    class_x = np.cos(class_polar).reshape((1, -1))
    class_y = np.sin(class_polar).reshape((1, -1))
    x = (probs * class_x).sum(1)
    y = (probs * class_y).sum(1)
    return (x, y), (class_x.squeeze(), class_y.squeeze())


def add_arrow(line, ax, position=None, direction="right", color=None, label="", dx=1):
    """A direction arrow on a trajectory ``line`` of ``ax``: from the point
    whose x is nearest ``position`` (default: the mean x) towards the point
    ``dx`` samples later (``direction="right"``) or earlier."""
    import matplotlib.patches as patches

    if color is None:
        color = line.get_color()
    xdata = np.asarray(line.get_xdata())
    ydata = np.asarray(line.get_ydata())
    if position is None:
        position = xdata.mean()
    start = int(np.argmin(np.abs(xdata - position)))
    end = start + dx if direction == "right" else start - dx
    end = int(np.clip(end, 0, len(xdata) - 1))
    ddx = xdata[end] - xdata[start]
    ddy = ydata[end] - ydata[start]
    size = abs(ddx) * 5.0
    arrow = patches.FancyArrow(
        xdata[start] + np.sign(ddx) * size / 2.0,
        ydata[start] + np.sign(ddy) * size / 2.0,
        ddx,
        ddy,
        color=color,
        width=0,
        head_width=size,
        head_length=size,
        label=label,
        length_includes_head=True,
        overhang=0.3,
        zorder=10,
    )
    ax.add_patch(arrow)


def plot_line_with_arrow(x, y, ax=None, label="", position=None, dx=10, **kw):
    """``ax.plot(x, y, **kw)`` (the current axes by default) with a direction
    arrow ``dx`` samples long; returns the line."""
    if ax is None:
        ax = pyplot().gca()
    line = ax.plot(x, y, **kw)[0]
    add_arrow(line, ax, label=label, position=position, dx=dx)
    return line
