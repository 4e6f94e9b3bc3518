"""network.bank_draw_s: host seconds the network runner spent drawing its
cross-cell banks' CDL links in set-up (``SyncNetworkRunner.stage_s
["bank_draws"]`` read right after ``_build_banks``, the runner's stage
``network.bank_draws``), the host part of ``network.bank_build_s``. Read in
a traced run, as every per-layer metric: an untraced context, or a program
without the stage, gives None. Moves setup_s."""


def read(ctx):
    if ctx.trace is None:
        return None
    value = (ctx.counters_setup.get("stage_s") or {}).get("bank_draws")
    return None if value is None else float(value)
