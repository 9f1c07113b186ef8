"""hvdtpu-top: live per-rank view of a running horovod_tpu_torch job.

The port of the JAX package's ``tools/hvdtpu_top.py``. The file
formats are the same in both packages, so this tool reads either
package's files, and the JAX package's tool reads the port's.

Tails the per-rank JSON-lines files the obs plane writes
(``HVDTPU_METRICS=1``, ``HVDTPU_METRICS_DIR``; schema in
``horovod_tpu_torch/obs/export.py``) and renders a refreshing table of rates —
steps/s, tokens/s, MFU, step-time breakdown, collective bytes, native
response-cache hit rate — plus the recent event stream (elastic
rescales, blacklists). Rates are derived from counter deltas between the
last two records of each file, so the tool needs no connection to the
job: point it at the metrics directory (NFS/GCS-fuse for multi-host) and
it reads what the ranks append.

Usage:
    python -m horovod_tpu_torch.tools.hvdtpu_top [--dir DIR] [--interval 2] [--once] [--json]
                               [--plain]

``--once`` prints one plain-text snapshot and exits (CI, logs);
``--json`` prints the same snapshot machine-readable (rows + events as
one JSON object) for soak/CI assertions.
Interactive mode uses curses when a TTY is available, degrading to a
clear-screen loop otherwise (``--plain`` forces the degraded mode).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TB"


def _tail_records(path: str, max_records: int = 2, max_bytes: int = 262144):
    """Last ``max_records`` JSON objects of a JSONL file, reading only
    the file's tail (these files grow for the life of a job)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(0, size - max_bytes))
            chunk = f.read().decode("utf-8", "replace")
    except OSError:
        return []
    records = []
    for line in chunk.splitlines()[1 if size > max_bytes else 0:]:
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            continue  # torn first/last line while the rank is writing
    return records[-max_records:]


def _rate(prev, cur, key) -> float:
    """Counter delta per second between two records (0 when unknowable)."""
    if not prev:
        return 0.0
    dt = cur.get("ts", 0) - prev.get("ts", 0)
    if dt <= 0:
        return 0.0
    return (
        (cur.get("counters") or {}).get(key, 0)
        - (prev.get("counters") or {}).get(key, 0)
    ) / dt


def collect(directory: str):
    """Per-rank row dicts + drained events from every JSONL in the dir."""
    rows, events = [], []
    paths = sorted(glob.glob(os.path.join(directory, "*.jsonl")))
    now = time.time()
    for path in paths:
        recs = _tail_records(path)
        if not recs:
            continue
        cur = recs[-1]
        prev = recs[-2] if len(recs) > 1 else None
        # Tolerant section access: panel rows are *discovered* from
        # whatever instruments a record carries — gauges appear mid-run
        # (autotune names only exist after warmup, serve names only
        # once a pool serves, per-host leases come and go), and a
        # record written by an older build may lack a whole section.
        # A missing name means "panel cell empty", never KeyError.
        c = cur.get("counters") or {}
        g = cur.get("gauges") or {}
        h = cur.get("histograms") or {}
        hits = c.get("native.cache_hits", 0)
        misses = c.get("native.cache_misses", 0)
        step_h = h.get("step.total_ms", {})
        disp_h = h.get("step.host_dispatch_ms", {})
        rows.append({
            "who": os.path.splitext(os.path.basename(path))[0],
            "age": now - cur.get("ts", now),
            "steps": c.get("step.count", 0),
            "steps_s": _rate(prev, cur, "step.count"),
            "tok_s": (
                _rate(prev, cur, "step.tokens")
                or g.get("step.tokens_per_sec", 0.0)
            ),
            "mfu": g.get("step.mfu"),
            "p50": step_h.get("p50"),
            "p95": step_h.get("p95"),
            "disp": disp_h.get("p50"),
            # Replicated steps fuse one allreduce; sharded (ZeRO-1)
            # steps move reduce-scatter + all-gather legs — sum both.
            "coll_b": g.get(
                "fusion.allreduce.bytes_per_step",
                g.get("fusion.reducescatter.bytes_per_step", 0.0)
                + g.get("fusion.allgather.bytes_per_step", 0.0),
            ),
            "eager_bs": _rate(prev, cur, "eager.bytes"),
            "cache": (hits / (hits + misses)) if hits + misses else None,
            "stalls": g.get("stall.pending", 0),
            # Static HBM plan of the running step (analysis/memory),
            # published by step.memplan()/step.lint; 0 = never planned.
            "mem_peak": g.get("memplan.peak_bytes", 0.0),
            "serve": _serve_row(prev, cur, c, g, h),
            "decode": _decode_row(prev, cur, c, g, h),
            "stream": _stream_row(c, g, h),
            "guard": _guard_row(c, g),
            "elastic": _elastic_row(c, g),
            "autotune": _autotune_row(c, g),
            "goodput": _goodput_row(g),
        })
        for ev in cur.get("events", []):
            events.append((ev.get("ts", 0), path, ev))
    events.sort(key=lambda e: e[0])  # ties would compare the event dicts
    return rows, events


def _serve_row(prev, cur, c, g, h):
    """Serving-plane cells for one rank record (None when the rank has
    never served — the serve panel only renders where it applies)."""
    if "serve.requests" not in c and "serve.queue_depth" not in g:
        return None
    lat = h.get("serve.request_ms", {})
    return {
        "qdepth": g.get("serve.queue_depth", 0),
        "in_flight": g.get("serve.in_flight", 0),
        "workers": g.get("serve.workers", 0),
        "fill": g.get("serve.batch_fill"),
        "req_s": _rate(prev, cur, "serve.responses"),
        "p50": lat.get("p50"),
        "p95": lat.get("p95"),
        "p99": lat.get("p99"),
        "requeued": c.get("serve.requeued", 0),
        "ckpt_step": g.get("serve.ckpt_step"),
        # Per-worker in-flight gauges: serve.in_flight.<worker>.
        "per_worker": {
            k[len("serve.in_flight."):]: int(v)
            for k, v in sorted(g.items())
            if k.startswith("serve.in_flight.")
        },
    }


def _decode_row(prev, cur, c, g, h):
    """Token-level decode cells for one rank record (None when the rank
    never ran the decode engine)."""
    if "serve.decode.tokens" not in c and "serve.decode.steps" not in c:
        return None
    ttft = h.get("serve.decode.ttft_ms", {})
    tpot = h.get("serve.decode.tpot_ms", {})
    return {
        "tok_s": g.get("serve.decode.tokens_per_s",
                       _rate(prev, cur, "serve.decode.tokens")),
        "fill": g.get("serve.decode.row_fill"),
        "ttft_p50": ttft.get("p50"),
        "tpot_p50": tpot.get("p50"),
        "kv_occ": g.get("serve.decode.kv_occupancy"),
        "kv_frag": g.get("serve.decode.kv_fragmentation"),
        "accept": g.get("serve.decode.accept_rate"),
        "requeued": c.get("serve.decode.requeued", 0),
        "preempted": c.get("serve.decode.preempted", 0),
    }


def _stream_row(c, g, h):
    """Live-weight-stream cells (None when the rank neither publishes
    nor subscribes — the panel only renders where it applies). One row
    shows both sides: trainers carry the published/blocked columns,
    decode hosts the applied/torn/staleness ones."""
    if not any(k.startswith("stream.") for k in c) and (
        "stream.version" not in g and "stream.staleness_s" not in g
    ):
        return None
    apply_ms = h.get("stream.apply_ms", {})
    return {
        "version": g.get("stream.version"),
        "published": c.get("stream.published_versions", 0),
        "blocked": c.get("stream.publish_blocked", 0),
        "dropped": c.get("stream.publish_dropped", 0),
        "applied": c.get("stream.applied_versions", 0),
        "torn": c.get("stream.torn_rejected", 0),
        "epoch_rej": c.get("stream.epoch_rejected", 0),
        "staleness": g.get("stream.staleness_s"),
        "apply_p50": apply_ms.get("p50"),
        "fallbacks": c.get("stream.fallbacks", 0),
        "rollbacks": c.get("stream.rollbacks", 0),
        "kv_keys": g.get("stream.kv_retained_keys"),
    }


def _guard_row(c, g):
    """Fail-silent defense cells (None when the rank never armed the
    guard — the panel only renders where it applies)."""
    if "guard.enabled" not in g and "guard.steps_skipped" not in c:
        return None
    return {
        "skipped": c.get("guard.steps_skipped", 0),
        "consec": g.get("guard.consecutive_skips", 0),
        "norm": g.get("guard.grad_norm"),
        "escalations": c.get("guard.escalations", 0),
        "audits": c.get("guard.audits", 0),
        "diverged": c.get("guard.divergences", 0),
        "resyncs": c.get("guard.resyncs", 0),
        "walkbacks": c.get("guard.walkbacks", 0),
    }


def _elastic_row(c, g):
    """Elastic-driver cells: round/world/blacklist plus per-host
    heartbeat-lease ages (``recovery.lease_age_seconds.<host>``), so an
    almost-expired lease is visible BEFORE the kill fires — and the
    control-plane HA vitals: driver epoch (0 = original incarnation,
    +1 per crash-adoption), journal size and replay lag (records since
    the last compacted snapshot), and which hosts are mid
    preemption-drain (``elastic.preempt_drain.<host>``), so an operator
    can watch an adoption or an eviction drain happen live."""
    leases = {
        k[len("recovery.lease_age_seconds."):]: v
        for k, v in sorted(g.items())
        if k.startswith("recovery.lease_age_seconds.")
    }
    if "elastic.round" not in g and not leases:
        return None
    return {
        "round": g.get("elastic.round"),
        "hosts": g.get("elastic.world_hosts"),
        "blacklisted": g.get("elastic.blacklisted_hosts", 0),
        "lease_expired": c.get("recovery.lease_expired", 0),
        "penalties": c.get("recovery.host_penalties", 0),
        "reports": c.get("guard.divergence_reports", 0),
        "leases": leases,
        "epoch": g.get("elastic.driver_epoch"),
        "journal_b": g.get("journal.bytes"),
        "journal_lag": g.get("journal.records"),
        "preempting": sorted(
            k[len("elastic.preempt_drain."):]
            for k, v in g.items()
            if k.startswith("elastic.preempt_drain.") and v
        ),
    }


def _autotune_row(c, g):
    """Closed-loop autotuner cells (None while no tuner runs). The
    candidate-vector columns are DISCOVERED from the
    ``autotune.candidate.<knob>`` gauge prefix — the knob set is
    config-dependent and the gauges only appear once the search starts,
    so a fixed name list would render an empty panel (or KeyError) for
    the whole warmup."""
    if not any(k.startswith("autotune.") for k in g) and (
        "autotune.trials" not in c
    ):
        return None
    return {
        "trial": g.get("autotune.trial"),
        "trials": c.get("autotune.trials", 0),
        "score": g.get("autotune.score"),
        "best": g.get("autotune.best_score"),
        "converged": bool(g.get("autotune.converged", 0)),
        "switches": c.get("autotune.switches", 0),
        "retraces": c.get("autotune.retraces", 0),
        "candidate": {
            k[len("autotune.candidate."):]: v
            for k, v in sorted(g.items())
            if k.startswith("autotune.candidate.")
        },
    }


def _goodput_row(g):
    """Goodput-ledger cells (None until the rank publishes the ledger —
    HVDTPU_GOODPUT=1). Categories are DISCOVERED from the
    ``goodput.<category>_s`` gauge suffix, so the panel tracks the
    ledger's closed set without a second copy of it here."""
    if "goodput.elapsed_s" not in g:
        return None
    cats = {
        k[len("goodput."):-len("_s")]: v
        for k, v in g.items()
        if k.startswith("goodput.") and k.endswith("_s")
        and k != "goodput.elapsed_s"
    }
    return {
        "fraction": g.get("goodput.fraction", 0.0),
        "elapsed": g.get("goodput.elapsed_s", 0.0),
        "top": sorted(
            ((c, v) for c, v in cats.items() if v > 0),
            key=lambda cv: -cv[1],
        )[:4],
    }


HEADER = (
    f"{'rank':<8} {'age':>5} {'steps':>8} {'steps/s':>8} {'tok/s':>10} "
    f"{'mfu':>6} {'p50ms':>8} {'p95ms':>8} {'disp':>7} {'coll/step':>10} "
    f"{'dcn B/s':>9} {'cache%':>7} {'stall':>5} {'hbm plan':>9}"
)


def _cell(v, fmt="{:.1f}", none="-"):
    return none if v is None else fmt.format(v)


def render(rows, events, directory: str) -> str:
    lines = [
        f"hvdtpu-top — {directory} — {time.strftime('%H:%M:%S')} — "
        f"{len(rows)} rank(s)",
        HEADER,
        "-" * len(HEADER),
    ]
    for r in rows:
        lines.append(
            f"{r['who']:<8} {r['age']:>4.0f}s {r['steps']:>8d} "
            f"{r['steps_s']:>8.2f} {r['tok_s']:>10.0f} "
            f"{_cell(r['mfu'], '{:.3f}'):>6} {_cell(r['p50']):>8} "
            f"{_cell(r['p95']):>8} {_cell(r['disp']):>7} "
            f"{_fmt_bytes(r['coll_b']):>10} {_fmt_bytes(r['eager_bs']):>9} "
            f"{_cell(r['cache'], '{:.1%}'):>7} {int(r['stalls']):>5d} "
            f"{_fmt_bytes(r['mem_peak']) if r['mem_peak'] else '-':>9}"
        )
    if not rows:
        lines.append(
            "  (no rank*.jsonl yet — is the job running with HVDTPU_METRICS=1?)"
        )
    serve_rows = [r for r in rows if r.get("serve")]
    if serve_rows:
        lines.append("")
        lines.append(
            f"serve — {'rank':<8} {'queue':>6} {'infl':>5} {'wrk':>4} "
            f"{'fill%':>6} {'req/s':>7} {'p50ms':>7} {'p95ms':>7} "
            f"{'p99ms':>7} {'requeue':>8} {'ckpt':>5}  per-worker"
        )
        for r in serve_rows:
            s = r["serve"]
            per = " ".join(
                f"{w}:{n}" for w, n in list(s["per_worker"].items())[:6]
            )
            lines.append(
                f"        {r['who']:<8} {int(s['qdepth']):>6d} "
                f"{int(s['in_flight']):>5d} {int(s['workers']):>4d} "
                f"{_cell(s['fill'], '{:.0%}'):>6} {s['req_s']:>7.1f} "
                f"{_cell(s['p50']):>7} {_cell(s['p95']):>7} "
                f"{_cell(s['p99']):>7} {int(s['requeued']):>8d} "
                f"{_cell(s['ckpt_step'], '{:.0f}'):>5}  {per}"
            )
    decode_rows = [r for r in rows if r.get("decode")]
    if decode_rows:
        lines.append("")
        lines.append(
            f"decode — {'rank':<8} {'tok/s':>8} {'fill%':>6} "
            f"{'ttft50':>7} {'tpot50':>7} {'kvocc%':>7} {'frag%':>6} "
            f"{'acc%':>5} {'requeue':>8} {'preempt':>8}"
        )
        for r in decode_rows:
            s = r["decode"]
            lines.append(
                f"         {r['who']:<8} {_cell(s['tok_s'], '{:.1f}'):>8} "
                f"{_cell(s['fill'], '{:.0%}'):>6} "
                f"{_cell(s['ttft_p50']):>7} {_cell(s['tpot_p50']):>7} "
                f"{_cell(s['kv_occ'], '{:.0%}'):>7} "
                f"{_cell(s['kv_frag'], '{:.0%}'):>6} "
                f"{_cell(s['accept'], '{:.0%}'):>5} "
                f"{int(s['requeued']):>8d} {int(s['preempted']):>8d}"
            )
    stream_rows = [r for r in rows if r.get("stream")]
    if stream_rows:
        lines.append("")
        lines.append(
            f"stream — {'rank':<8} {'ver':>7} {'pub':>5} {'blkd':>5} "
            f"{'drop':>5} {'appl':>5} {'torn':>5} {'eprej':>6} "
            f"{'stale_s':>8} {'apply50':>8} {'fallbk':>7} {'rollbk':>7} "
            f"{'kvkeys':>7}"
        )
        for r in stream_rows:
            s = r["stream"]
            lines.append(
                f"         {r['who']:<8} "
                f"{_cell(s['version'], '{:.0f}'):>7} "
                f"{int(s['published']):>5d} {int(s['blocked']):>5d} "
                f"{int(s['dropped']):>5d} {int(s['applied']):>5d} "
                f"{int(s['torn']):>5d} {int(s['epoch_rej']):>6d} "
                f"{_cell(s['staleness']):>8} {_cell(s['apply_p50']):>8} "
                f"{int(s['fallbacks']):>7d} {int(s['rollbacks']):>7d} "
                f"{_cell(s.get('kv_keys'), '{:.0f}'):>7}"
            )
    guard_rows = [r for r in rows if r.get("guard")]
    if guard_rows:
        lines.append("")
        lines.append(
            f"guard — {'rank':<8} {'skip':>6} {'consec':>7} {'gnorm':>10} "
            f"{'escal':>6} {'audits':>7} {'diverg':>7} {'resync':>7} "
            f"{'wlkbk':>6}"
        )
        for r in guard_rows:
            gr = r["guard"]
            lines.append(
                f"        {r['who']:<8} {int(gr['skipped']):>6d} "
                f"{int(gr['consec']):>7d} {_cell(gr['norm'], '{:.3g}'):>10} "
                f"{int(gr['escalations']):>6d} {int(gr['audits']):>7d} "
                f"{int(gr['diverged']):>7d} {int(gr['resyncs']):>7d} "
                f"{int(gr['walkbacks']):>6d}"
            )
    elastic_rows = [r for r in rows if r.get("elastic")]
    if elastic_rows:
        lines.append("")
        lines.append(
            f"elastic — {'who':<8} {'round':>6} {'epoch':>6} {'hosts':>6} "
            f"{'blkl':>5} {'expired':>8} {'penalty':>8} {'reports':>8} "
            f"{'jrnl':>8} {'lag':>5}  lease age (s) / preempt"
        )
        for r in elastic_rows:
            er = r["elastic"]
            leases = " ".join(
                f"{h}:{age:.1f}" for h, age in list(er["leases"].items())[:6]
            )
            if er["preempting"]:
                leases += "  preempt:" + ",".join(er["preempting"][:4])
            jrnl = (
                "-" if er["journal_b"] is None
                else _fmt_bytes(er["journal_b"])
            )
            lines.append(
                f"          {r['who']:<8} "
                f"{_cell(er['round'], '{:.0f}'):>6} "
                f"{_cell(er['epoch'], '{:.0f}'):>6} "
                f"{_cell(er['hosts'], '{:.0f}'):>6} "
                f"{int(er['blacklisted']):>5d} {int(er['lease_expired']):>8d} "
                f"{int(er['penalties']):>8d} {int(er['reports']):>8d} "
                f"{jrnl:>8} {_cell(er['journal_lag'], '{:.0f}'):>5}  "
                f"{leases}"
            )
    tune_rows = [r for r in rows if r.get("autotune")]
    if tune_rows:
        lines.append("")
        lines.append(
            f"autotune — {'who':<8} {'trial':>6} {'done':>5} {'score':>11} "
            f"{'best':>11} {'switch':>7} {'retrc':>6}  candidate"
        )
        for r in tune_rows:
            t = r["autotune"]
            cand = " ".join(
                f"{k}={_fmt_bytes(v) if k == 'FUSION_THRESHOLD' else f'{v:g}'}"
                for k, v in list(t["candidate"].items())[:6]
            )
            lines.append(
                f"           {r['who']:<8} "
                f"{_cell(t['trial'], '{:.0f}'):>6} "
                f"{'yes' if t['converged'] else 'no':>5} "
                f"{_cell(t['score'], '{:.4g}'):>11} "
                f"{_cell(t['best'], '{:.4g}'):>11} "
                f"{int(t['switches']):>7d} {int(t['retraces']):>6d}  {cand}"
            )
    goodput_rows = [r for r in rows if r.get("goodput")]
    if goodput_rows:
        lines.append("")
        lines.append(
            f"goodput — {'who':<8} {'useful%':>8} {'elapsed':>9}  "
            "top categories (s)"
        )
        for r in goodput_rows:
            gp = r["goodput"]
            tops = "  ".join(f"{c}={v:.1f}" for c, v in gp["top"])
            lines.append(
                f"          {r['who']:<8} {gp['fraction'] * 100:>7.1f}% "
                f"{gp['elapsed']:>8.1f}s  {tops}"
            )
    if events:
        lines.append("")
        lines.append("recent events:")
        for ts, path, ev in events[-5:]:
            desc = " ".join(
                f"{k}={v}" for k, v in ev.items() if k not in ("ts", "kind")
            )
            lines.append(
                f"  {time.strftime('%H:%M:%S', time.localtime(ts))} "
                f"[{os.path.basename(path)}] {ev.get('kind', '?')} {desc}"
            )
    return "\n".join(lines)


def run_plain_loop(directory: str, interval: float) -> None:
    try:
        while True:
            rows, events = collect(directory)
            sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(render(rows, events, directory), flush=True)
            time.sleep(interval)
    except KeyboardInterrupt:
        pass


def run_curses(directory: str, interval: float) -> None:
    import curses

    def loop(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        while True:
            rows, events = collect(directory)
            scr.erase()
            maxy, maxx = scr.getmaxyx()
            for y, line in enumerate(render(rows, events, directory).split("\n")):
                if y >= maxy - 1:
                    break
                attr = curses.A_BOLD if y == 0 else curses.A_NORMAL
                try:
                    scr.addnstr(y, 0, line, maxx - 1, attr)
                except curses.error:
                    pass
            scr.addnstr(
                min(maxy - 1, 1 + len(render(rows, events, directory).split("\n"))),
                0, "q to quit", maxx - 1, curses.A_DIM,
            )
            scr.refresh()
            t_end = time.time() + interval
            while time.time() < t_end:
                ch = scr.getch()
                if ch in (ord("q"), ord("Q")):
                    return
                time.sleep(0.05)

    curses.wrapper(loop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--dir",
        default=os.environ.get(
            "HVDTPU_METRICS_DIR", os.path.join(os.getcwd(), "hvdtpu_metrics")
        ),
        help="metrics directory (HVDTPU_METRICS_DIR)",
    )
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true", help="one snapshot, exit")
    ap.add_argument(
        "--json", action="store_true",
        help="one machine-readable snapshot (implies --once): the "
        "collected rows and events as a JSON object, so soak/CI "
        "scripts assert on panel values instead of scraping the table",
    )
    ap.add_argument(
        "--plain", action="store_true",
        help="clear-screen loop instead of curses",
    )
    args = ap.parse_args(argv)

    if args.json:
        rows, events = collect(args.dir)
        print(json.dumps({
            "dir": args.dir,
            "rows": rows,
            "events": [
                {"ts": ts, "source": os.path.basename(path), "event": ev}
                for ts, path, ev in events
            ],
        }, sort_keys=True))
        return 0 if rows else 1
    if args.once:
        rows, events = collect(args.dir)
        print(render(rows, events, args.dir))
        return 0 if rows else 1
    if not args.plain and sys.stdout.isatty():
        try:
            run_curses(args.dir, args.interval)
            return 0
        except Exception:
            pass  # no terminfo / not a real tty: degrade
    run_plain_loop(args.dir, args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
