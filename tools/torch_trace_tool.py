"""The port's trace tool: merge, export and analyze a job's obs dir.

The counterpart of ``tools/trace_tool.py`` over ``rabit_tpu_torch``'s own
modules (it imports nothing of ``rabit_tpu`` or JAX), with the same
arguments and outputs.  It joins the ranks' ``flight-*.jsonl`` dumps and
the tracker's ``telemetry.json`` under one ``RABIT_OBS_DIR`` into one
job-wide timeline (``rabit_tpu_torch/obs/trace.py``).  Run the job with
``rabit_trace_exit=1`` so that clean ranks dump at finalize, then:

  python tools/torch_trace_tool.py export  OBS_DIR [-o trace.json] [--no-fold]
      merge everything into Chrome/Perfetto trace_event JSON (open it in
      https://ui.perfetto.dev), validated; the straggler report is folded
      into telemetry.json unless --no-fold.  With --follow, tail a live
      run: the trace is rewritten every --interval seconds from the spill
      dumps (rabit_obs_spill_sec) so far, and the loop ends with the strict
      export once the job's telemetry file appears.

  python tools/torch_trace_tool.py report  OBS_DIR [--top K] [--json]
                                           [--flag-links HOST:PORT]
      arrival-skew analytics a collective: the top-K stragglers by
      lateness, the worst collectives by skew, recovery-affected
      collectives apart.  --flag-links pushes the links the report implies
      (sched.links_from_stragglers over the job's last planned ring) into
      the live tracker at HOST:PORT as origin-stamped slow_link reports,
      which ask for a repair wave at the next version boundary.

  python tools/torch_trace_tool.py diagnose OBS_DIR [--top K] [--json] [--fold]
      the critical path a round (rabit_tpu_torch/obs/critical.py): each
      collective round compute-gated (entry skew: the last entering rank),
      link-gated (excess drain: the incoming planned-ring link of the rank
      that drains last) or balanced; the top gating ranks and links (with
      the streamed link_wait_seconds rollup) and the recovery waves' cost.
      --fold writes the report into telemetry.json under critical_path and
      stamps a critical_path_folded event.

  python tools/torch_trace_tool.py validate TRACE_JSON
      check an exported trace against the trace_event subset the exporter
      emits.

The exit status is non-zero on a merge or validation error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rabit_tpu_torch.obs import trace  # noqa: E402


def cmd_export(args: argparse.Namespace) -> int:
    rounds = 0
    if args.follow:
        doc, path, report, rounds = trace.export_follow(
            args.obs_dir, out_path=args.out, interval=args.interval,
            fold=not args.no_fold, top_k=args.top, job_key=args.job,
            max_rounds=args.max_rounds)
    else:
        doc, path, report = trace.export_job(
            args.obs_dir, out_path=args.out, fold=not args.no_fold,
            top_k=args.top, job_key=args.job)
    n_spans = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    other = doc["otherData"]
    line = {
        "trace": path,
        "ranks": other["ranks"],
        "dumps_merged": other["dumps_merged"],
        "spans": n_spans,
        "events": len(doc["traceEvents"]),
        "collectives_analyzed": report["collectives_analyzed"],
        "clock_max_err_s": other["clock_max_err_s"],
    }
    if args.follow:
        line["follow_rounds"] = rounds
    print(json.dumps(line))
    return 0


def flag_links_from_report(report: dict, telemetry: dict, addr: str,
                           wait_share: float = 0.5) -> list[tuple[int, int]]:
    """Push a straggler report's implied degraded links into a live
    tracker (the offline half of the repair loop).

    The ring the lateness shares indict is the job's LAST planned order
    (``schedule_planned`` events in telemetry; identity ring when the
    job predates planning).  Each implied ``(src, dst)`` link rides the
    SAME wire as a worker self-report — a ``slow_link`` print the
    tracker ingests as a ``link_degraded`` event — so the avoid-set
    machinery, the rewave arming, and the telemetry evidence are
    byte-for-byte the live path's."""
    from rabit_tpu_torch import sched
    from rabit_tpu_torch.tracker import protocol as P

    planned = [e for e in (telemetry.get("events") or [])
               if e.get("kind") == "schedule_planned"]
    if planned and planned[-1].get("ring_order"):
        ring = [int(r) for r in planned[-1]["ring_order"]]
    else:
        ring = list(range(int(telemetry.get("world_size", 0) or 0)))
    links = sorted(sched.links_from_stragglers(report, ring,
                                               wait_share=wait_share))
    host, _, port_s = addr.rpartition(":")
    if not host:
        raise ValueError(f"--flag-links wants HOST:PORT, got {addr!r}")
    for src, dst in links:
        line = (f"[{dst}] slow_link src={src} dst={dst} wait=0.0 "
                f"share=1.0 origin=trace_tool")
        P.tracker_rpc(host, int(port_s), P.CMD_PRINT, "trace_tool",
                      message=line, timeout=5.0, retries=1)
    return links


def cmd_report(args: argparse.Namespace) -> int:
    job = trace.load_job(args.obs_dir, job_key=args.job)
    report = trace.straggler_report(job, top_k=args.top)
    if args.write_telemetry:
        trace.fold_into_telemetry(args.obs_dir, report, job_key=args.job)
    if args.flag_links:
        links = flag_links_from_report(report, job.telemetry or {},
                                       args.flag_links,
                                       wait_share=args.wait_share)
        print(json.dumps({"flagged_links": [list(l) for l in links],
                          "tracker": args.flag_links}))
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
        return 0
    print(f"collectives: {report['collectives_analyzed']} analyzed, "
          f"{report['collectives_recovery_affected']} recovery-affected, "
          f"{report['collectives_total']} total "
          f"(clock err <= {report['clock_max_err_s']*1e3:.3f} ms)")
    print("top stragglers (by cumulative arrival lateness):")
    for i, s in enumerate(report["top_stragglers"], 1):
        print(f"  #{i} rank {s['rank']}: "
              f"late {s['lateness_total_s']*1e3:.3f} ms total "
              f"({s['lateness_share']*100:.1f}% of job lateness), "
              f"last-arriver in {s['last_arriver_count']}/{s['arrivals']} "
              f"collectives, made peers wait {s['wait_total_s']*1e3:.3f} ms")
    print("worst collectives (by first-enter vs last-enter skew):")
    for w in report["worst_skews"]:
        print(f"  {w['op']} v{w['version']}.{w['seqno']}: "
              f"skew {w['skew_s']*1e3:.3f} ms, last rank {w['last_rank']}")
    return 0


def cmd_diagnose(args: argparse.Namespace) -> int:
    from rabit_tpu_torch.obs import critical

    job = trace.load_job(args.obs_dir, job_key=args.job)
    report = critical.critical_path_report(job, margin_sec=args.margin,
                                           top_k=args.top)
    if args.fold:
        critical.fold_critical_path(args.obs_dir, report, job_key=args.job)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
        return 0
    gates = report["rounds_by_gate"]
    print(f"rounds: {report['rounds_analyzed']} analyzed "
          f"(compute-gated {gates['compute']}, link-gated {gates['link']}, "
          f"balanced {gates['balanced']}), "
          f"{report['rounds_recovery_affected']} recovery-affected "
          f"of {report['rounds_total']} total")
    print(f"latency: {report['latency_total_s']*1e3:.3f} ms across analyzed "
          f"rounds (base drain {report['base_drain_s']*1e3:.3f} ms/round, "
          f"entry skew {report['entry_skew_total_s']*1e3:.3f} ms total)")
    if report["top_gating_ranks"]:
        print("top gating ranks (compute critical path):")
        for r in report["top_gating_ranks"]:
            print(f"  rank {r['rank']}: gated {r['rounds']} round(s), "
                  f"cost {r['cost_s']*1e3:.3f} ms")
    if report["top_gating_links"]:
        print("top gating links (ring critical path):")
        for l in report["top_gating_links"]:
            streamed = (f", streamed wait {l['streamed_wait_s']*1e3:.3f} ms"
                        if "streamed_wait_s" in l else "")
            print(f"  link {l['src']}->{l['dst']}: gated {l['rounds']} "
                  f"round(s), cost {l['cost_s']*1e3:.3f} ms{streamed}")
    if report["recovery_waves"]:
        print(f"recovery waves: {len(report['recovery_waves'])}, total "
              f"cost {report['recovery_cost_s']*1e3:.3f} ms")
    return 0


def cmd_validate(args: argparse.Namespace) -> int:
    with open(args.trace_json) as f:
        doc = json.load(f)
    errs = trace.validate_chrome_trace(doc)
    if errs:
        for e in errs[:20]:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(f"OK: {len(doc['traceEvents'])} events validate")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="merge per-rank flight dumps + telemetry.json into one "
                    "Perfetto trace and straggler report")
    sub = ap.add_subparsers(dest="cmd", required=True)

    exp = sub.add_parser("export", help="write Chrome/Perfetto trace JSON")
    exp.add_argument("obs_dir")
    exp.add_argument("-o", "--out", default=None,
                     help="output path (default: OBS_DIR/trace.json)")
    exp.add_argument("--job", default="", metavar="KEY",
                     help="select one job of a multi-job obs dir "
                          "(reads telemetry-KEY.json)")
    exp.add_argument("--top", type=int, default=3)
    exp.add_argument("--no-fold", action="store_true",
                     help="do not fold straggler aggregates into "
                          "telemetry.json")
    exp.add_argument("--follow", action="store_true",
                     help="tail mode: atomically rewrite the trace every "
                          "--interval seconds from the live spill dumps "
                          "(rabit_obs_spill_sec) until the job's telemetry "
                          "file appears, then run the final strict export")
    exp.add_argument("--interval", type=float, default=1.0,
                     help="seconds between follow-mode rounds")
    exp.add_argument("--max-rounds", type=int, default=None,
                     help="stop following after N rounds even if the job "
                          "is still live")
    exp.set_defaults(fn=cmd_export)

    rep = sub.add_parser("report", help="straggler analytics")
    rep.add_argument("obs_dir")
    rep.add_argument("--job", default="", metavar="KEY",
                     help="select one job of a multi-job obs dir "
                          "(reads telemetry-KEY.json)")
    rep.add_argument("--top", type=int, default=3)
    rep.add_argument("--json", action="store_true")
    rep.add_argument("--write-telemetry", action="store_true",
                     help="fold the report into telemetry.json")
    rep.add_argument("--flag-links", default="", metavar="HOST:PORT",
                     help="push the report's implied degraded links into "
                          "a live tracker (arms a repair replan)")
    rep.add_argument("--wait-share", type=float, default=0.5,
                     help="lateness-share threshold for --flag-links")
    rep.set_defaults(fn=cmd_report)

    diag = sub.add_parser("diagnose",
                          help="per-round critical-path postmortem")
    diag.add_argument("obs_dir")
    diag.add_argument("--job", default="", metavar="KEY",
                      help="select one job of a multi-job obs dir "
                           "(reads telemetry-KEY.json)")
    diag.add_argument("--top", type=int, default=3)
    diag.add_argument("--margin", type=float, default=0.02,
                      help="noise margin in seconds below which a round "
                           "is balanced (default 0.02)")
    diag.add_argument("--json", action="store_true")
    diag.add_argument("--fold", action="store_true",
                      help="fold the report into telemetry.json under "
                           "critical_path")
    diag.set_defaults(fn=cmd_diagnose)

    val = sub.add_parser("validate", help="validate an exported trace")
    val.add_argument("trace_json")
    val.set_defaults(fn=cmd_validate)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except trace.TraceError as exc:
        print(f"trace merge failed: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
