"""Serving launcher, after ``repro.launch.serve``: the paper's technique
as a deployed feature, on the CUDA card (``--device cpu``: the host).

Host mode runs the continuous-batching engine with the two-tier Morpheus
page pool on a reduced config, with the weights of
``models.seeded_numpy_params(cfg, 0)`` (the reference draws
``model.init(PRNGKey(0))``, which the port cannot reproduce).  The
reference's pod mode (``--mesh pod|multipod``, ``--dry-run``: the
sharded one-token ``serve_step`` lowered for the production mesh) needs
more than one device and raises (ROADMAP A8.4).

``--split`` chooses the page pool's mode split: an integer pins the
cache-chip count; ``auto`` attaches the adaptive runtime governor
(``repro_torch.runtime.ServingGovernor``), which adjusts the split
between rounds from the pool's observed request mix and reports each
decision.  ``--workload``/``--arrival`` replace the fixed demo batches
with the serving schedule of ``repro_torch.workloads.serving``;
``--slo-ms`` sizes rounds by the SLO budgeter; ``--tenant-slo
name:slo_ms[:weight[:priority]],...`` budgets per tenant, and
``--admission`` sheds or defers the lowest-priority tenants when the
joint SLO set is unattainable (``repro_torch.runtime.admission``).
Every flag is the reference's; ``main(argv)`` takes an argument list.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --split auto --workload tenantA,tenantB --arrival onoff:64,0.5,0.5
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --split auto --workload tenantA,tenantB --slo-ms 2.5
"""
import argparse
import time

POD_ERROR = ("--mesh pod|multipod and --dry-run lower the production mesh, "
             "which needs more than one device (ROADMAP A8.4)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--no-morpheus", action="store_true",
                    help="disable the extended cache tier")
    ap.add_argument("--split", default="static",
                    help="'auto' = adaptive mode-split governor; an "
                         "integer pins the cache-chip count")
    ap.add_argument("--rounds", type=int, default=None,
                    help="serving rounds (default 2, or 6 with "
                         "--split auto)")
    ap.add_argument("--workload", default=None,
                    help="tenant prompt families, comma-joined (e.g. "
                         "'tenantA,tenantB'); default: one demo family")
    ap.add_argument("--arrival", default=None,
                    help="per-round arrival process: det:R | poisson:R | "
                         "mmpp:Ra,Rb,Ta,Tb | onoff:R,Ton,Toff (R in "
                         "requests/second of schedule time; default: "
                         "fixed --batch per round)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="SLO-driven round sizing: a closed-loop "
                         "budgeter converts observed ns/lookup into the "
                         "next round's request budget so each round's "
                         "modeled service time tracks this target "
                         "(replaces --arrival's fixed round sizes)")
    ap.add_argument("--tenant-slo", default=None, metavar="SPEC",
                    help="per-tenant SLO budgeting: "
                         "'name:slo_ms[:weight[:priority]],...' — one "
                         "SLO per tenant family, round budgets "
                         "apportioned by weight x learned per-tenant "
                         "cost (largest remainder); supersedes --slo-ms "
                         "and --workload (the names ARE the families)")
    ap.add_argument("--admission", action="store_true",
                    help="with --tenant-slo: admission control — shed/"
                         "defer lowest-priority tenants when the joint "
                         "SLO set is unattainable, deferred work aged "
                         "back in (docs/qos.md), overload pressure fed "
                         "to the --split auto governor")
    ap.add_argument("--mesh", choices=("host", "pod", "multipod"),
                    default="host")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable observability and write a Chrome/"
                         "Perfetto trace-event JSON here on exit "
                         "(docs/observability.md)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable observability and write the metrics "
                         "registry here on exit (.json = snapshot, "
                         "anything else = Prometheus text)")
    ap.add_argument("--inspect-out", default=None, metavar="PATH",
                    help="enable the cache microscope and write the "
                         "decoded pool content snapshots (one per round) "
                         "here on exit — render with 'obs_report heatmap'")
    ap.add_argument("--record-trace", default=None, metavar="PATH",
                    help="attach the pool's block-level event recorder "
                         "(lookup/insert/evict ring) and export it as a "
                         "corpus .npz here on exit")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.mesh != "host" or args.dry_run:
        raise SystemExit(f"serve: {POD_ERROR}")

    from repro_torch import obs
    if args.trace_out or args.metrics_out or args.inspect_out:
        obs.enable(trace=args.trace_out is not None,
                   inspect=args.inspect_out is not None)

    from repro_torch import configs
    from repro_torch.core.engine import resolve_device
    from repro_torch.models import build_model, seeded_numpy_params
    from repro_torch.serving import Engine, Request

    if args.no_morpheus and args.split != "static":
        ap.error("--split pins/adapts the extended tier; it conflicts "
                 "with --no-morpheus")
    if args.tenant_slo and args.slo_ms:
        ap.error("--tenant-slo supersedes --slo-ms; pick one")
    if args.admission and not args.tenant_slo:
        ap.error("--admission needs --tenant-slo (per-tenant budgets "
                 "are what it apportions under overload)")

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch).reduced()
    model = build_model(cfg, device=dev)
    params = seeded_numpy_params(cfg, 0)
    pool = governor = None
    if args.split not in ("static", "auto"):
        from repro_torch.runtime import demo_pool
        pool = demo_pool(int(args.split), dev)
    eng = Engine(model, params,
                 max_len=args.prompt_len + args.max_new + 8,
                 morpheus=not args.no_morpheus, pool=pool)
    if args.record_trace:
        eng.pool.attach_recorder()
    if args.split == "auto":
        from repro_torch.runtime import SERVING_GCFG, ServingGovernor
        # the conservative preset: idle windows and bursty rounds swing
        # the per-tick signature, which thrashes the default config
        governor = ServingGovernor(eng.pool, gcfg=SERVING_GCFG)
        print(f"governor: candidates {governor.gov.candidates}, starting "
              f"at {eng.pool.cfg.num_cache_chips} cache chips")
    prompt = [(5 * j + 11) % 89 + 1 for j in range(args.prompt_len)]
    rounds = args.rounds or (6 if governor or args.slo_ms
                             or args.tenant_slo else 2)
    budgeter = tbudgeter = ctrl = None
    if args.tenant_slo:
        from repro_torch.runtime.admission import AdmissionController
        from repro_torch.workloads.serving import (
            TenantSLO, TenantSLOBudgeter, proportional_interleave,
            tenant_prompts)
        tenants = []
        for spec in args.tenant_slo.split(","):
            parts = [p.strip() for p in spec.strip().split(":")]
            if not 2 <= len(parts) <= 4:
                ap.error(f"bad --tenant-slo entry {spec!r} (want "
                         "name:slo_ms[:weight[:priority]])")
            tenants.append(TenantSLO(
                parts[0], float(parts[1]),
                weight=float(parts[2]) if len(parts) > 2 else 1.0,
                priority=int(parts[3]) if len(parts) > 3 else 0))
        tbudgeter = TenantSLOBudgeter(tenants, max_total=4 * args.batch,
                                      initial_total=args.batch)
        fams = dict(tenant_prompts(",".join(t.name for t in tenants),
                                   args.prompt_len))
        if args.admission:
            ctrl = AdmissionController(tenants)
        sched = None
        print("tenant-slo budgeter: " + " ".join(
            f"{t.name}:{t.slo_ms:g}ms(w{t.weight:g},p{t.priority})"
            for t in tenants)
            + (" | admission control on" if ctrl is not None else ""))
    elif args.slo_ms:
        from repro_torch.workloads.serving import SLOBudgeter, slo_batches
        budgeter = SLOBudgeter(args.slo_ms, max_batch=4 * args.batch,
                               initial_batch=args.batch)
        batches = slo_batches(args.workload or "demo", budgeter,
                              args.prompt_len)
        sched = None
        print(f"slo budgeter: target {args.slo_ms:g} ms/round, "
              f"budget {budgeter.min_batch}..{budgeter.max_batch} reqs")
    elif args.workload or args.arrival:
        from repro_torch.workloads.serving import round_requests
        sched = round_requests(args.workload or "demo",
                               args.arrival or f"det:{args.batch}",
                               rounds, args.batch, args.prompt_len)
    else:
        sched = [[("demo", prompt)] * args.batch for _ in range(rounds)]
    rid = 0
    pool_last = eng.pool.stats
    tenant_slo = {}          # tenant -> [rounds met, rounds seen]
    for rnd in range(rounds):
        # SLO modes re-size each round from the latest telemetry; the
        # pre-built schedule is only consulted in the fixed modes
        pressure = 0.0
        if tbudgeter is not None:
            budgets = tbudgeter.next_budgets()
            if ctrl is not None:
                # fresh offered demand: --batch requests per tenant; the
                # controller decides who runs within the round budgets
                plan = ctrl.plan({t.name: args.batch for t in tenants},
                                 budgets)
                serve = plan.served()
                pressure = plan.pressure
            else:
                plan, serve = None, budgets
            counts = [serve[t.name] for t in tenants]
            batch = [(tenants[k].name, fams[tenants[k].name])
                     for k in proportional_interleave(counts)]
        elif budgeter is not None:
            batch = next(batches)
        else:
            batch = sched[rnd]
        round_ = "cold" if rnd == 0 else f"warm{rnd}"
        if not batch:
            print(f"[{round_}] idle window (no arrivals)")
            if governor is not None:
                from repro_torch.runtime import describe_tick
                print("  " + describe_tick(governor.tick(pressure)))
            continue
        reqs = [Request(rid=rid + i, prompt=toks,
                        max_new_tokens=args.max_new, tenant=name)
                for i, (name, toks) in enumerate(batch)]
        rid += len(reqs)
        from repro_torch.workloads.serving import batch_mix
        mix = batch_mix(batch)
        t0 = time.time()
        with obs.span("serve.round", round=rnd, requests=len(reqs),
                      tenants=len(mix)):
            rep = eng.run(reqs)
        dt = time.time() - t0
        tenant_note = "" if len(mix) == 1 and "demo" in mix else \
            " | tenants " + "+".join(f"{k}:{v}" for k, v in mix.items())
        print(f"[{round_}] {rep.generated} tokens in {dt:.2f}s "
              f"({rep.generated / dt:.1f} tok/s) | prefix pages reused "
              f"{rep.pages_reused}, backing fetches {rep.pages_fetched}"
              f"{tenant_note}")
        if budgeter is not None:
            d = eng.pool.stats - pool_last
            pool_last = eng.pool.stats
            ns_per = d.time_ns / d.lookups if d.lookups else 0.0
            budgeter.observe(ns_per, d.lookups, len(reqs))
            est = budgeter.ns_per_request or 0.0
            print(f"  slo: {est * len(reqs) / 1e6:.3f} ms modeled "
                  f"(target {args.slo_ms:g}) | {est / 1e3:.1f} us/req | "
                  f"next budget {budgeter.next_budget()} | per tenant "
                  + " ".join(f"{k}:{v}" for k, v in mix.items()))
            if obs.metrics_on():
                # every tenant in the round shares its SLO outcome
                round_ms = (d.time_ns / 1e6) if d.lookups else 0.0
                met = round_ms <= args.slo_ms
                for tenant, n in mix.items():
                    t = tenant_slo.setdefault(tenant, [0, 0])
                    t[0] += met
                    t[1] += 1
                    obs.set_gauge("tenant_slo_attainment",
                                  t[0] / t[1], tenant=tenant)
                    obs.count("tenant_requests", n, tenant=tenant)
        if tbudgeter is not None:
            d = eng.pool.stats - pool_last
            pool_last = eng.pool.stats
            round_ms = (d.time_ns / 1e6) if d.lookups else 0.0
            tbudgeter.observe(mix, round_ms)
            line = (f"  tenant-slo: {round_ms:.3f} ms round | budgets "
                    + " ".join(f"{k}:{v}" for k, v in budgets.items())
                    + " | attain "
                    + " ".join(f"{t.name}:{tbudgeter.attainment(t.name):.2f}"
                               for t in tenants))
            if ctrl is not None:
                line += (f" | pressure {pressure:.2f}"
                         + (f" backlog {ctrl.backlog()}"
                            if ctrl.backlog() else ""))
                dropped = [e.compact() for e in plan.events
                           if e.kind in ("defer", "shed", "resume")]
                if dropped:
                    line += " | " + " ".join(dropped)
            print(line)
        if governor is not None:
            from repro_torch.runtime import describe_tick
            print("  " + describe_tick(governor.tick(pressure)))
        else:
            # no governor tick to snapshot through: the microscope
            # captures the pool content at every round boundary itself
            ins = obs.inspector()
            if ins is not None and ins.wants(rnd):
                ins.record(eng.pool.content_snapshot(epoch=rnd,
                                                     owners=ins.owners))
                obs.count("state_snapshots", 1, path="serving")
    s = eng.pool.stats
    print(f"pool: conv {s.conv_hits} hits | ext {s.ext_hits} hits | "
          f"pred-miss {s.ext_pred_miss} | false-pos {s.ext_false_pos}")
    if budgeter is not None and tenant_slo:
        print("slo attainment: " + " ".join(
            f"{k}:{met}/{n}" for k, (met, n) in tenant_slo.items()))
    if tbudgeter is not None:
        print("tenant-slo attainment: " + " ".join(
            f"{t.name}:{tbudgeter.attainment(t.name):.2f}"
            for t in tenants))
        if ctrl is not None:
            print("admission: " + " ".join(
                f"{k}:{v}" for k, v in ctrl.counters.items())
                + f" | backlog {ctrl.backlog()}")
    if args.record_trace and eng.pool.recorder is not None \
            and len(eng.pool.recorder):
        p = eng.pool.recorder.save(args.record_trace)
        c = eng.pool.recorder.counts()
        print(f"record-trace: {p} (" + " ".join(
            f"{k}:{v}" for k, v in c.items()) + ")")
    _save_obs(args)


def _save_obs(args) -> None:
    from repro_torch import obs
    if args.trace_out and obs.tracing():
        p = obs.tracer().save(args.trace_out)
        print(f"trace-out: {p}")
    if args.metrics_out and obs.metrics_on():
        p = obs.metrics_registry().save(args.metrics_out)
        print(f"metrics-out: {p}")
    ins = obs.inspector()
    if getattr(args, "inspect_out", None) and ins is not None:
        p = ins.save(args.inspect_out)
        print(f"inspect-out: {p} ({len(ins.snapshots)} snapshots)")


if __name__ == "__main__":
    main()
