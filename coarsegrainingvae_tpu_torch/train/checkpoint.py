"""Full-state checkpoints with resume (port of
``coarsegrainingvae_tpu.train.checkpoint``).

A checkpoint is the complete train state -- parameters by name, the Adam
``count``/``mu``/``nu``, the step counter and the learning rate -- plus a
small JSON of host-side metadata (epoch, controller and early-stop
counters, history), so a killed run restarts where it stopped.

Layout, as the JAX package's: ``directory/<step>/`` per step with
``meta_<step>.json`` beside it, and the newest ``max_to_keep`` steps kept.
The format is the port's own, not orbax: ``<step>/state.pt`` is one
``torch.save`` of plain CPU tensors, which ``torch.load(...,
weights_only=True)`` reads back. A step is written under a temporary name
and renamed into place, so a save that is killed never becomes
``latest_step()``. A step directory that the JAX package's orbax wrote
(``_CHECKPOINT_METADATA``, ``default/``) raises
``OrbaxCheckpointError``, which names the converter
(``scripts/convert_run.py --to torch``, run where JAX is installed): a
resume never starts afresh over it, and ``Backmapper.from_run`` and
``cli/postanalysis`` never read past it.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import torch

from coarsegrainingvae_tpu_torch.train.trainer import AdamState, TrainState

STATE_FILE = "state.pt"
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "default")
CONVERTER = "scripts/convert_run.py"


class OrbaxCheckpointError(ValueError):
    """A checkpoint directory holds the JAX package's orbax steps."""


def _is_orbax_step(path: str) -> bool:
    return (not os.path.isfile(os.path.join(path, STATE_FILE))
            and any(os.path.exists(os.path.join(path, m)) for m in ORBAX_MARKERS))


def _payload(state: TrainState) -> Dict:
    """The plain-tensor dict a checkpoint stores (CPU copies)."""
    def cpu(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True)

    opt = state.opt_state
    return {
        "params": {name: cpu(p) for name, p in state.params.items()},
        "opt_state": {"count": cpu(opt.count), "mu": cpu(opt.mu), "nu": cpu(opt.nu)},
        "step": cpu(state.step),
        "lr": cpu(state.lr),
    }


class CheckpointManager:
    """Step-based checkpoints under ``directory/<step>/`` with retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"meta_{step}.json")

    def all_steps(self):
        """Completed steps, oldest first; raises OrbaxCheckpointError on a
        step of the JAX package's."""
        digits = [d for d in os.listdir(self.directory) if d.isdigit()]
        orbax = [d for d in digits if _is_orbax_step(os.path.join(self.directory, d))]
        if orbax:
            fold = os.path.dirname(self.directory)
            raise OrbaxCheckpointError(
                f"{self.directory} holds orbax checkpoints of the JAX package "
                f"(steps {sorted(orbax, key=int)}); convert the run first, where JAX "
                f"is installed: python {CONVERTER} --to torch {fold}")
        return sorted(int(d) for d in digits
                      if os.path.isfile(os.path.join(self.directory, d, STATE_FILE)))

    def save(self, step: int, state: TrainState, metadata: Optional[Dict] = None) -> None:
        """Save the train state; metadata is a small JSON-able dict (epoch,
        controller counters, ...)."""
        self.save_payload(step, _payload(state), metadata)

    def save_payload(self, step: int, payload: Dict, metadata: Optional[Dict] = None) -> None:
        """Save a payload of CPU tensors as ``read`` returns it (e.g. from
        ``convert.train_state_from_flax``)."""
        tmp = os.path.join(self.directory, f".tmp_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if metadata is not None:
            meta_tmp = os.path.join(tmp, "meta.json")
            with open(meta_tmp, "w") as f:
                json.dump(metadata, f)
            os.replace(meta_tmp, self._meta_path(step))
        final = self._step_dir(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
                if os.path.exists(self._meta_path(old)):
                    os.remove(self._meta_path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read(self, step: Optional[int] = None) -> Tuple[Dict, Dict, int]:
        """(stored tensors on the CPU, metadata, step) of ``step`` or the
        latest one; raises FileNotFoundError when there is none."""
        latest = self.latest_step()
        step = latest if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        payload = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                             map_location="cpu", weights_only=True)
        metadata: Dict = {}
        if os.path.exists(self._meta_path(step)):
            with open(self._meta_path(step)) as f:
                metadata = json.load(f)
        return payload, metadata, step

    def restore(self, template_state: TrainState,
                step: Optional[int] = None) -> Tuple[TrainState, Dict, int]:
        """Restore (state, metadata, step) into ``template_state``, built by
        ``Trainer.init_state``. Its parameters are the model's own: the
        stored values are copied into them in place, so the model trains
        the restored tensors. The moments, count, step and lr are new
        tensors on the template's device. Names, shapes and dtypes must
        match."""
        payload, metadata, step = self.read(step)
        params = template_state.params
        stored = payload["params"]
        if set(stored) != set(params):
            raise KeyError(f"checkpoint parameters differ from the model's: "
                           f"missing {sorted(set(params) - set(stored))}, "
                           f"unexpected {sorted(set(stored) - set(params))}")

        def like(t: torch.Tensor, ref: torch.Tensor, name: str) -> torch.Tensor:
            if t.shape != ref.shape or t.dtype != ref.dtype:
                raise ValueError(f"checkpoint {name}: {t.dtype} {tuple(t.shape)}, "
                                 f"expected {ref.dtype} {tuple(ref.shape)}")
            return t.to(ref.device)

        with torch.no_grad():
            for name, p in params.items():
                p.copy_(like(stored[name], p, name))
        opt, ref = payload["opt_state"], template_state.opt_state
        state = TrainState(
            params=params,
            opt_state=AdamState(count=like(opt["count"], ref.count, "count"),
                                mu=like(opt["mu"], ref.mu, "mu"),
                                nu=like(opt["nu"], ref.nu, "nu")),
            step=like(payload["step"], template_state.step, "step"),
            lr=like(payload["lr"], template_state.lr, "lr"),
        )
        return state, metadata, step

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX package's
        interface."""
