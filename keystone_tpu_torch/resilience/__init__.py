"""Resilience — port of ``keystone_tpu/resilience``'s fault injection
(:mod:`.faults`, env-gated by ``KEYSTONE_FAULTS``), request-path
watchdog (:mod:`.watchdog`), retry policies (:mod:`.retry`) and the one
emission schema they share (:mod:`.emit`). Guards, cluster membership
and chaos campaigns are not ported yet."""
