"""The harness: one run of one cell.

A run builds the cell's configuration in the port, makes its weights from
the seed, warms every shape its calls use (set-up), then calls the program
back to back for the window (one caller, a closed loop), each call's
inputs drawn from the seed and the call's index just before it starts. With tracing off it reports the cell's end-to-end metrics; with it
on, a window of calls whose stages end in a synchronisation (the stage
times, the MFU) and then a few calls under ``torch.profiler`` (rooflines,
launches, idle share, the breakdown) give its per-layer metrics. Either
way a sample of the window's calls, drawn from the seed, is judged against
the reference once the window has closed.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mld_tpu")
CHECK_CALLS = 2      # window calls judged, drawn from the seed (and one more
                     # at the longest text bucket the calls reach)
TRACED_CALLS = 6     # calls under the profiler in a traced run
# caches of the program and its libraries: fixed paths in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age() -> float:
    """Seconds since this process started (its start time from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Cell:
    """A cell of BENCHMARK.json with its files: the configuration, the
    traffic mix, the limits and the family."""

    def __init__(self, name: str, bench: dict = None, home: Path = HERE):
        """`home` is the benchmark's folder, beside BENCHMARK.json."""
        bench = bench or load_json(home.parent / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        confs = {c["name"]: c for c in bench["configs"]}
        self.conf = load_json(home.parent
                              / confs[self.entry["config"]]["file"])
        self.spec = load_json(home / "traffic"
                              / f"{self.entry['traffic']}.json")
        check = load_json(home / "workloads" / f"{name}.json")
        self.limits, self.bars = check["limits"], check.get("bars", {})
        self.family = importlib.import_module(
            f"benchmark.families.{self.conf['family']}")
        e2e = bench["end_to_end"]
        self.end_to_end = [m for m in e2e
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


class Capture:
    """What the harness sees of a call: spans at the program's stage
    methods (and its own tokenize and copy), the arguments and result of
    each stage of a recorded call (cloned), the host's clock at each span's
    edges with a synchronisation at each end (stage timing), and profiler
    ranges (tracing)."""

    def __init__(self, torch, sync):
        self.torch, self.sync = torch, sync
        self.record = None
        self.marks = None
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.profiling:
            rf = self.torch.profiler.record_function("bench." + name)
            rf.__enter__()
        if self.marks is not None:
            self.marks.append((name, 0, time.perf_counter()))
        try:
            yield
        finally:
            if self.marks is not None:
                self.sync()
                self.marks.append((name, 1, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    def clone(self, v):
        return v.clone() if self.torch.is_tensor(v) else v

    def note(self, key: str, value):
        if self.record is not None:
            self.record[key] = self.clone(value)

    def install(self, program, hooks: dict):
        """Wrap each of the program's stage methods, by instance."""
        for method, stage in hooks.items():
            fn = getattr(program, method)
            setattr(program, method, self._wrap(method, stage, fn))

    def _wrap(self, method, stage, fn):
        sig = inspect.signature(fn)

        def wrapper(*args, **kwargs):
            with self.span(stage):
                out = fn(*args, **kwargs)
                if self.record is not None:
                    bound = sig.bind(*args, **kwargs).arguments
                    self.record[method] = (
                        {k: self.clone(v) for k, v in bound.items()},
                        self.clone(out))
            return out
        return wrapper


class Sampler:
    """The calls to judge, drawn from the seed as the window runs (each
    kept with the chance that leaves a uniform sample of `k`), and one
    more among the calls at the longest text bucket the calls reach."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng([int(seed) % 2 ** 64, 0x5a3])
        self.k = k
        self.slots, self.seen = {}, [0, 0]

    def take(self, n: int, longest: bool) -> list:
        """Slots call n would fill, if any."""
        out = []
        for tag, size, ok in (("any", self.k, True),
                              ("longest", 1, longest)):
            if not ok:
                continue
            i = self.seen[tag == "longest"]
            self.seen[tag == "longest"] += 1
            j = i if i < size else int(self.rng.integers(0, i + 1))
            if j < size:
                out.append((tag, j))
        return out

    def records(self) -> list:
        """[(call index, record)] of the kept calls, each once."""
        seen, out = set(), []
        for n, rec in self.slots.values():
            if n not in seen:
                seen.add(n)
                out.append((n, rec))
        return out


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


class Run:
    """One run of a cell: set-up, the window, the traced phases; ``execute``
    drives it."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", env: dict = None):
        self.cell, self.seed, self.seconds, self.trace = (cell, seed,
                                                          seconds, trace)
        self.device = device
        self.env = dict(cell.spec["env"], **(env or {}))
        self.next_call = 0
        self.t_start = time.perf_counter() - process_age()

    # ------------------------------------------------------------ set-up
    def setup(self):
        """Build, weights, inputs, warm-up; the host's seconds of each part
        (after the imports before it) go to ``setup_parts``."""
        parts, mark = {}, [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            parts[name] = now - mark[0]
            mark[0] = now

        parts["before_setup"] = mark[0] - self.t_start
        for k, v in self.env.items():
            os.environ[k] = v
        for k, sub in CACHE_DIRS.items():
            os.environ[k] = str(ROOT / "build" / "bench_cache" / sub)
        os.environ["USE_FLAX"] = os.environ["USE_TF"] = "0"
        import torch
        from benchmark.reference import weights as wts
        self.torch = torch
        fam, conf = self.cell.family, self.cell.conf
        lap("import_torch")
        self.program = fam.build(conf, self.device)
        self.sync()
        lap("build_program")
        shapes = {k: tuple(v.shape)
                  for k, v in self.program.state_dict().items()}
        self.weights = wts.make(shapes, self.seed, self.device)
        self.program.load_state_dict(self.weights, strict=True)
        self.inputs = fam.Inputs(conf, self.cell.spec, self.seed,
                                 self.device)
        self.sync()
        lap("weights_and_inputs")
        self.cap = Capture(torch, self.sync)
        self.cap.install(self.program, fam.HOOKS)
        with torch.no_grad():
            for i, b in enumerate(self.inputs.warm_calls()):
                self.one_call(b)
                self.sync()
                lap(f"warm_call_{i}")
        gc.collect()                   # set-up's garbage, before the window
        if "cpu_threads" in self.cell.spec:
            # a deployment setting the mix states: the serving loop's
            # intra-op CPU threads
            torch.set_num_threads(self.cell.spec["cpu_threads"])
        self.setup_parts = parts

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def one_call(self, b: dict):
        with self.cap.span("call"):
            out = self.cell.family.call(self.program, b, self.cap)
            with self.cap.span("copy"):
                host = out.cpu()
        self.cap.note("joints", host)
        return host

    # ------------------------------------------------------------ window
    def window(self, seconds: float, sampler: Sampler = None,
               n_calls: int = None) -> dict:
        """Calls back to back for `seconds` (or `n_calls`); the calls that
        start inside it are all run to their end. Each call's inputs are
        drawn just before it starts, inside the window and outside the
        call's latency; calls are numbered on from the run's last."""
        starts, ends, failed, motions, batches = [], [], 0, 0, []
        k = 0
        t0 = time.perf_counter()
        while True:
            if n_calls is not None and k >= n_calls:
                break
            if n_calls is None and k and time.perf_counter() - t0 >= seconds:
                break
            n = self.next_call
            self.next_call += 1
            b = self.inputs.call(n)
            slots = sampler.take(n, self.inputs.longest(n)) if sampler \
                else []
            self.cap.record = {} if slots else None
            ok = True
            s = time.perf_counter()
            try:
                with self.torch.no_grad():
                    self.one_call(b)
            except Exception:          # a failed call counts as missing
                traceback.print_exc()
                ok = False
            e = time.perf_counter()
            if slots and ok:
                for slot in slots:
                    sampler.slots[slot] = (n, self.cap.record)
            self.cap.record = None
            starts.append(s)
            ends.append(e)
            failed += not ok
            motions += b["B"] if ok else 0
            batches.append({key: b[key] for key in ("B", "bucket",
                                                    "lengths")})
            k += 1
        span = ends[-1] - starts[0]
        lat = [e - s for s, e in zip(starts, ends)]
        return {"calls": k, "failed": failed, "motions": motions,
                "seconds": span, "latencies": lat, "batches": batches}

    # ------------------------------------------------------------ tracing
    def traced(self) -> dict:
        """Stage times over a window; then profiled calls."""
        self.cap.marks = []
        sampler = Sampler(self.seed, CHECK_CALLS)
        a = self.window(self.seconds, sampler)
        marks, self.cap.marks = self.cap.marks, None
        spans, cur, opened = [], None, {}
        for name, edge, t in marks:
            if name == "call" and edge == 0:
                cur = {}
                spans.append(cur)
            if edge == 0:
                opened[name] = t
            else:
                cur[name] = cur.get(name, 0.0) + t - opened.pop(name)
        from torch.profiler import ProfilerActivity, profile
        self.cap.profiling = True
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            b = self.window(0.0, None, TRACED_CALLS)
            self.sync()
        self.cap.profiling = False
        events = prof.events()
        return {"a": a, "spans": spans, "sampler": sampler,
                "prof": b, "events": events}

    # ------------------------------------------------------------ judge
    def judge(self, recs: list) -> dict:
        return self.cell.family.judge(self.weights, recs, self.cell.conf,
                                      self.cell.spec, self.seed, self.device,
                                      self.cell.bars)


class Trace:
    """What the per-layer readers read: the stage spans of the timed
    window, the profiled calls with their device events and host ranges,
    and the cell's files."""

    def __init__(self, run: Run, t: dict):
        self.cell, self.env = run.cell, run.env
        self.spans = t["spans"]
        self.window_a = t["a"]
        self.prof_batches = t["prof"]["batches"]
        dev, host = [], []
        cuda = run.torch.autograd.DeviceType.CUDA
        for e in t["events"]:
            r = e.time_range
            if e.name.startswith("bench."):
                # the host's ranges; their copies on the device's timeline
                # (user annotations) are not device work
                if e.device_type != cuda:
                    host.append((e.name[len("bench."):], r.start, r.end))
            elif e.device_type == cuda:
                dev.append((e.name, r.start, r.end))
        calls = [h for h in host if h[0] == "call"]
        self.t0 = min(h[1] for h in calls)
        self.t1 = max(h[2] for h in calls)
        self.window_s = (self.t1 - self.t0) / 1e6
        self.events = [(n, max(s, self.t0), min(e, self.t1)) for n, s, e in dev
                       if e > self.t0 and s < self.t1]
        self.host = host
        self.n_calls = len(calls)
        self.busy_s = self._union(self.events) / 1e6

    @staticmethod
    def _union(iv) -> float:
        total, end = 0.0, None
        start = None
        for _, s, e in sorted(iv, key=lambda x: x[1]):
            if end is None or s > end:
                if end is not None:
                    total += end - start
                start, end = s, e
            else:
                end = max(end, e)
        if end is not None:
            total += end - start
        return total

    def device_seconds(self, patterns) -> float:
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for n, s, e in self.events
                   if any(r.search(n) for r in rx)) / 1e6

    def roofline(self, kernel: str):
        """100 x the kernel's least time over its device time, for the
        profiled calls; None where the calls launch it nowhere."""
        from benchmark.kernels import peaks
        mod = importlib.import_module(f"benchmark.kernels.{kernel}")
        least = 0.0
        for b in self.prof_batches:
            for l in self.cell.family.launches(self.cell.conf, b,
                                               self.env).get(kernel, []):
                least += peaks.least_seconds(*mod.work(l), l["arith"])
        dev = self.device_seconds(mod.PATTERNS)
        if least <= 0 or dev <= 0:
            return None
        return 100.0 * least / dev

    def gaps(self) -> list:
        """Idle intervals of the device in the window [(label, seconds)],
        each labelled with the innermost benchmark span the host was in
        at its start ("call" between the stages of a call)."""
        out, end = [], self.t0
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            out.append((end, self.t1))
        labelled = []
        for s, e in out:
            inside = [h for h in self.host if h[1] <= s < h[2]]
            label = min(inside, key=lambda h: h[2] - h[1])[0] \
                if inside else "between_calls"
            labelled.append((label, (e - s) / 1e6))
        return labelled

    def breakdown(self) -> dict:
        by_name = {}
        for n, s, e in self.events:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        gaps = sorted(self.gaps(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def nvidia_smi_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def checks(numbers: dict, limits: dict) -> dict:
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in numbers.items()}


def correct_of(chk: dict, failed: int) -> bool:
    return failed == 0 and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in chk.values())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", env: dict = None, bench: dict = None,
            chips: int = 1, home: Path = HERE) -> dict:
    """One run; returns the result line's object (without printing). `env`
    overlays the traffic file's environment (the CPU tests' K1 switch)."""
    cell = Cell(cell_name, bench, home)
    run = Run(cell, seed, seconds, trace, device, env)
    run.setup()
    torch = run.torch
    setup_s = time.perf_counter() - run.t_start
    if trace:
        t = run.traced()
        a, sampler = t["a"], t["sampler"]
    else:
        sampler = Sampler(seed, CHECK_CALLS)
        a = run.window(seconds, sampler)
    run.sync()
    cuda = device != "cpu"
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    result = {"correct": False, "attempted": a["calls"],
              "failed": a["failed"], "metrics": {}}
    lat = a["latencies"]
    if trace:
        tr = Trace(run, t)
        tr.flops = sum(cell.family.flops(cell.conf, b) for b in a["batches"])
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(tr)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v),
                                                "unit": m["unit"]}
    else:
        result["window"] = {"seconds": a["seconds"], "p50_ms": percentile(
            [x * 1e3 for x in lat], 50.0)}
        values = {"motions_per_s": a["motions"] / a["seconds"],
                  "call_ms_p95": percentile(
                      [x * 1e3 for x in lat], 95.0) if not a["failed"]
                  else a["seconds"] * 1e3,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": float(values[m["name"]]),
                                            "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(0) if cuda
                        else "cpu", "count": chips,
                        "memory_peak_bytes": peak,
                        "power_limit": nvidia_smi_limit() if cuda else None}
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    # the window is closed: free the program, then judge
    recs = sampler.records()
    run.program = run.inputs = None
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = run.judge(recs)
    result["judge_s"] = time.perf_counter() - t_judge
    result["setup_parts"] = run.setup_parts
    result["judged_calls"] = len(recs)
    chk = checks(numbers, cell.limits)
    result["correct"] = correct_of(chk, a["failed"])
    result["checks"] = chk
    return result
