"""network.bank_build_s: host seconds the network runner spent building its
cross-cell banks in set-up (``SyncNetworkRunner.stage_s["banks"]`` read right
after ``_build_banks``). Moves setup_s."""


def read(ctx):
    value = ctx.counters_setup.get("bank_build_s")
    return None if value is None else float(value)
