"""The port's observability kit (``utils/observability.py``) against the JAX
package's: ``ProgressLogger``'s history (each row's time its own batch's)
and ``energy_absorption_report`` on the same results (exact: both read the
same float32 numbers, the report sums in float64), ``plot_progress`` writes
a PNG, ``profile_trace`` writes a trace, and ``utils`` exports what the JAX
``utils`` exports."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu import utils as jutils
from montecarlopredictivecoding_tpu.utils import observability as jobs
from montecarlopredictivecoding_tpu_torch import utils
from montecarlopredictivecoding_tpu_torch.utils import observability as obs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def results():
    """Three batches of a PC trainer's per-step results (JAX), as numpy."""
    gen = mcpc.GenerativeModel(
        mcpc.PCModel([mcpc.Linear(2, 2), mcpc.PC(), mcpc.Linear(2, 3)]), key=0)
    tr = mcpc.PCTrainer(gen, T=30, optimizer_x_fn="adam", optimizer_x_kwargs={"lr": 0.1},
                        update_p_at="never", optimizer_p_fn=None)
    out = []
    for k in range(3):
        data = jax.random.normal(jax.random.PRNGKey(k), (4, 3))
        r = tr.train_on_batch(jnp.zeros((4, 2)), loss_fn=mcpc.fe_fn,
                              loss_fn_kwargs={"_target": data, "_var": 1.0})
        out.append({key: np.asarray(r[key]) for key in ("loss", "energy", "overall")})
    return out


def _as_tensors(rows):
    return [{k: torch.from_numpy(v.copy()) for k, v in r.items()} for r in rows]


def test_progress_logger_history_matches_jax(results, capsys):
    log, jlog = obs.ProgressLogger(every=2, prefix="p "), jobs.ProgressLogger(every=2, prefix="p ")
    for r, t in zip(results, _as_tensors(results)):
        log(t, T=30)
        jlog(r, T=30)
    printed = capsys.readouterr().out
    assert printed.count("p h=") == 4 and "steps/s" in printed  # h = 0, 2 from each
    keep = ("h", "loss", "energy", "overall")
    assert [{k: row[k] for k in keep} for row in log.history] == \
        [{k: row[k] for k in keep} for row in jlog.history]
    assert all(row["steps_per_sec"] > 0 for row in log.history)


class _SlowRead:
    """A results entry whose host read takes ``delay`` seconds, as a read
    that waits for the card's work."""

    def __init__(self, delay):
        self.delay = delay

    def __array__(self, dtype=None, copy=None):
        time.sleep(self.delay)
        return np.zeros(3, np.float32)


def test_progress_logger_charges_a_slow_read_to_its_own_row():
    log = obs.ProgressLogger(every=1000)
    fast = {k: torch.zeros(3) for k in ("loss", "energy", "overall")}
    slow = dict(fast, loss=_SlowRead(0.3))
    for r in (fast, slow, fast):
        log(r, T=10)
    seconds = [row["seconds"] for row in log.history]
    assert seconds[1] >= 0.3 and seconds[2] < 0.3
    assert log.history[1]["steps_per_sec"] <= 10 / 0.3
    assert list(log.history[0]) == ["h", "loss", "energy", "overall", "seconds", "steps_per_sec"]


def test_energy_absorption_report_matches_jax(results):
    rep = obs.energy_absorption_report(_as_tensors(results))
    assert rep == jobs.energy_absorption_report(results)
    assert rep["mean_absorption"] > 0


def test_plot_progress_writes_a_png(results, tmp_path):
    path = obs.plot_progress(_as_tensors(results), path=str(tmp_path / "progress.png"))
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with obs.profile_trace(str(tmp_path / "prof")) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "prof")
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_utils_exports_what_jax_utils_exports():
    names = ("ProgressLogger", "energy_absorption_report", "plot_progress", "profile_trace",
             "slow_down_warning")
    for name in names:
        assert name in jutils.__all__ and name in utils.__all__
        assert getattr(utils, name) is getattr(obs, name)
    with pytest.warns(RuntimeWarning, match="option <x> slows down training"):
        utils.slow_down_warning("caller", "x", "False")
    assert mt.utils is utils
