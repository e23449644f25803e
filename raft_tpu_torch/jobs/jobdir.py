"""Durable on-disk state of one job: the JobDir layout + stage manifest
(counterpart of raft_tpu/jobs/jobdir.py; the files are byte-compatible
with the JAX package's both ways).

A `JobDir` is the unit of resumability. Everything a killed run needs to
continue lives under one directory:

    <root>/
      MANIFEST.jsonl        one line per committed stage (append-only)
      artifacts/            committed stage outputs (CRC-verified on skip)
      scratch/<stage>/      intra-stage checkpoints (stream cursor, ...)
      heartbeat             watchdog heartbeat file

Manifest lines are the commit protocol: a stage is COMPLETE iff its
latest manifest line carries the stage's current fingerprint AND every
artifact it names still matches its recorded whole-file CRC-32C. Lines
carry provenance — git SHA and the active fault-plan fingerprint — so a
resumed chaos drill is auditable, but provenance does NOT join the
fingerprint: re-running the same job at a new commit (or without the
drill's plan installed) must SKIP completed stages, not redo them.
The fingerprint is (stage name, declared inputs, dependency
fingerprints), so changing an input or any upstream stage re-runs the
stage and everything downstream.

Durability discipline matches the rest of the library: artifacts are
written via `core.serialize.atomic_write` (temp-then-rename, so SIGKILL
never leaves a torn artifact under a committed name), and the manifest
append terminates a torn final line first (the `obs.ledger` pattern) so
a crash mid-append can't swallow the next commit. Reads skip
unparseable lines.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from raft_tpu_torch.core.serialize import atomic_write, crc32c

MANIFEST_NAME = "MANIFEST.jsonl"

#: manifest schema version (bump on incompatible line-shape changes)
MANIFEST_VERSION = 1


def fingerprint_of(payload: Any) -> str:
    """Deterministic fingerprint of a JSON-able payload: CRC-32C of its
    canonical (sorted-keys, compact) JSON encoding, as 8 hex chars.
    Collisions only cost a spurious re-run, never a wrong skip-decision
    on unrelated STAGES (the stage name is always part of the payload)."""
    blob = json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()
    return f"{crc32c(blob):08x}"


def file_crc32c(path: str, chunk_bytes: int = 1 << 22) -> int:
    """Whole-file CRC-32C, streamed (artifacts can be multi-GB)."""
    crc = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(chunk_bytes)
            if not chunk:
                return crc
            crc = crc32c(chunk, crc)


class JobDir:
    """One job's durable directory (layout in the module docstring)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.fspath(root))
        os.makedirs(self.artifacts_dir, exist_ok=True)
        os.makedirs(os.path.join(self.root, "scratch"), exist_ok=True)

    # -- layout --------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    @property
    def artifacts_dir(self) -> str:
        return os.path.join(self.root, "artifacts")

    @property
    def heartbeat_path(self) -> str:
        return os.path.join(self.root, "heartbeat")

    def artifact_path(self, stage: str, name: str = "artifact") -> str:
        """Canonical path for a stage's committed artifact. Stage fns
        write here (through `serialize` / `atomic_write`) and name it in
        their commit; the path is stable so a resumed downstream stage
        finds it without re-running the producer."""
        return os.path.join(self.artifacts_dir, f"{stage}.{name}")

    def scratch(self, stage: str) -> str:
        """Per-stage scratch dir for INTRA-stage checkpoints (stream
        cursors, partial tables). Never committed; cleared by the runner
        when a stage starts over with a changed fingerprint."""
        d = os.path.join(self.root, "scratch", stage)
        os.makedirs(d, exist_ok=True)
        return d

    def clear_scratch(self, stage: str) -> None:
        import shutil

        shutil.rmtree(os.path.join(self.root, "scratch", stage),
                      ignore_errors=True)

    def clear_artifacts(self, stage: str) -> None:
        """Delete a stage's committed artifact files. Invalidation must
        call this alongside `clear_scratch`: the runner's default-artifact
        auto-discovery (`os.path.exists(artifact_path)`) would otherwise
        re-commit a previous fingerprint's leftover file — with a freshly
        computed CRC, so it verifies forever — as the new run's output."""
        d = self.artifacts_dir
        if not os.path.isdir(d):
            return
        prefix = f"{stage}."
        for name in os.listdir(d):
            if name.startswith(prefix):
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass  # a locked file resurfaces as a CRC/size mismatch

    # -- manifest ------------------------------------------------------
    def read_manifest(self) -> List[dict]:
        """All parseable manifest lines, in append order. Unparseable
        (torn) lines are skipped — a killed append never poisons the
        job."""
        if not os.path.exists(self.manifest_path):
            return []
        out: List[dict] = []
        with open(self.manifest_path, "r", encoding="utf-8",
                  errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(entry, dict):
                    out.append(entry)
        return out

    def committed(self, stage: str) -> Optional[dict]:
        """The LATEST manifest entry for `stage` (later lines win: a
        re-run after an input change appends a fresh commit)."""
        entry = None
        for e in self.read_manifest():
            if e.get("stage") == stage:
                entry = e
        return entry

    def commit(
        self,
        stage: str,
        fingerprint: str,
        artifacts: Optional[Dict[str, str]] = None,
        meta: Optional[dict] = None,
        provenance: Optional[dict] = None,
    ) -> dict:
        """Append one commit line for `stage`. `artifacts` maps artifact
        names to paths (absolute or JobDir-relative); each is recorded
        with its whole-file CRC-32C + size, verified again before any
        future run skips the stage. `meta` is the stage's JSON-able
        result (handed to dependents on skip)."""
        arts = {}
        for name, path in (artifacts or {}).items():
            full = path if os.path.isabs(path) else os.path.join(self.root,
                                                                 path)
            crc = file_crc32c(full)
            st = os.stat(full)
            arts[name] = {
                "path": os.path.relpath(full, self.root),
                "crc32c": crc,
                "nbytes": st.st_size,
                "mtime_ns": st.st_mtime_ns,
            }
        entry = {
            "v": MANIFEST_VERSION,
            "stage": stage,
            "fingerprint": fingerprint,
            "artifacts": arts,
            "meta": meta or {},
        }
        entry.update(provenance or {})
        self._append(entry)
        return entry

    def _append(self, entry: dict) -> None:
        """Torn-line-terminating append (the `obs.ledger` discipline): a
        previous process SIGKILLed mid-append leaves an unterminated
        line; terminating it first keeps this entry parseable."""
        line = json.dumps(entry, sort_keys=True)
        with open(self.manifest_path, "a+b") as fh:
            fh.seek(0, os.SEEK_END)
            if fh.tell() > 0:
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) != b"\n":
                    fh.write(b"\n")
            fh.write(line.encode() + b"\n")

    # -- completion / verification -------------------------------------
    def artifact_ok(self, entry: dict) -> bool:
        """True when every artifact a manifest entry names still exists
        with its recorded CRC — the gate between 'skip' and 're-run'.
        A deleted or rotted artifact fails closed (re-run the stage).

        Fast path: a file whose (size, mtime_ns) still equal the values
        recorded at commit time is accepted without re-reading it — the
        make/bazel up-to-date contract, without which every resume of a
        100M-scale job would re-CRC hundreds of GB just to decide
        'skip'. Any metadata change falls back to the full streamed CRC
        (which remains the ground truth: a CRC match with a changed
        mtime still passes)."""
        for art in (entry.get("artifacts") or {}).values():
            full = os.path.join(self.root, art["path"])
            try:
                st = os.stat(full)
            except OSError:
                return False
            if st.st_size != int(art["nbytes"]):
                return False
            rec_mtime = art.get("mtime_ns")
            if rec_mtime is not None and st.st_mtime_ns == int(rec_mtime):
                continue
            if file_crc32c(full) != int(art["crc32c"]):
                return False
        return True

    def is_complete(self, stage: str, fingerprint: str) -> Optional[dict]:
        """The committed entry when `stage` is complete at this
        fingerprint (artifacts verified), else None."""
        entry = self.committed(stage)
        if entry is None or entry.get("fingerprint") != fingerprint:
            return None
        if not self.artifact_ok(entry):
            return None
        return entry

    def resolve(self, entry_path: str) -> str:
        """JobDir-relative artifact path -> absolute."""
        return os.path.join(self.root, entry_path)

    # -- small durable sidecars ----------------------------------------
    @staticmethod
    def write_json(path: str, payload: dict) -> None:
        """Atomic JSON sidecar write (cursors, progress markers) — the
        ONE writer for every sidecar in the subsystem, so durability
        policy can't drift between the manifest and the cursors."""
        with atomic_write(path) as tmp:
            with open(tmp, "w") as fh:
                json.dump(payload, fh, sort_keys=True)

    @staticmethod
    def read_json(path: str) -> Optional[dict]:
        """Read a sidecar; None when missing or torn (fail open to a
        fresh start, never to a wrong resume)."""
        try:
            with open(path) as fh:
                out = json.load(fh)
            return out if isinstance(out, dict) else None
        except (OSError, json.JSONDecodeError):
            return None
