"""Online integrity for live indexes (counterpart of raft_tpu/integrity):
the ported names of the JAX package's `__all__`, in its order.

- digests (`integrity.digest`): per-list / per-table CRC-32C sidecars,
  attached at build, kept fresh by every mutation, carried through save /
  load;
- scrubbing (`integrity.scrub`): a bounded re-hash walker between serve
  batches, and the seeded rot injector (`integrity.table.rot`);
- quarantine and repair (`integrity.watchdog`): a bad list masked through
  the tombstones (`coverage()` < 1.0), then repaired from the mutation
  root's checkpoint, verified before it is swapped in; a distributed
  index's rotted ranks named by their shard digests and repaired from
  their ring mirrors;
- point-in-time recovery (`integrity.restore`): `restore(root, seq)`, the
  newest verifiable retained snapshot plus a bounded log replay, byte for
  byte the checkpoint a crash-free run committed at that seq.

`restore` here is the function (as in the JAX package); reach the module
with `importlib.import_module("raft_tpu_torch.integrity.restore")`.
"""

from raft_tpu_torch.integrity.digest import (  # noqa: F401
    DIGEST_FIELDS,
    IntegrityError,
    attach,
    check_fresh,
    compute,
    refresh,
    verify,
)
from raft_tpu_torch.integrity.restore import (  # noqa: F401
    prune,
    restore,
    retained,
    snapshot_path,
)
from raft_tpu_torch.integrity.scrub import (  # noqa: F401
    ROT_SITE,
    SCRUB_CRASH_SITE,
    Scrubber,
    maybe_rot,
    rot_list,
)
from raft_tpu_torch.integrity.watchdog import (  # noqa: F401
    IntegrityWatchdog,
    checkpoint_repairer,
    maybe_rot_mnmg,
    mnmg_digests,
    quarantine,
    repair_ranks,
    rot_rank,
    verify_mnmg,
)

__all__ = [
    "DIGEST_FIELDS",
    "IntegrityError",
    "IntegrityWatchdog",
    "ROT_SITE",
    "SCRUB_CRASH_SITE",
    "Scrubber",
    "attach",
    "check_fresh",
    "checkpoint_repairer",
    "compute",
    "maybe_rot",
    "maybe_rot_mnmg",
    "mnmg_digests",
    "prune",
    "quarantine",
    "refresh",
    "repair_ranks",
    "restore",
    "retained",
    "rot_list",
    "rot_rank",
    "snapshot_path",
    "verify",
    "verify_mnmg",
]
