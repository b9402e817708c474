"""Faults planted in the program's timed path, to show that the check
fails them (`portbench/tests/test_faults.py` on the CPU; `calibrate.py
--fault` on the card, where a training fault's readings set the upper end
of a limit). Each is a context manager that patches the program's classes
and puts them back.

  * "unchanged": a train step that leaves the state as it was (forward and
    backward run; no optimizer step, no table update);
  * "half_batch": a train step on the first half of the batch's rows only,
    its loss the mean over them;
  * "altered_answer": the first row of each answer altered where it is
    produced (a returned id moved to another item, a logit moved by 0.5);
  * "no_exchange": on a mesh, the gradients' exchange between ranks left
    out: each rank's dense gradients are scaled as the trainer scales them
    but never summed over the ranks (`Trainer._average_gradients`).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

FAULTS = ("unchanged", "half_batch", "altered_answer", "no_exchange")


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    from recommendflow_tpu_torch.export.exporter import ServingModel
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    from recommendflow_tpu_torch.train.trainer import Trainer
    saved = []

    def patch(owner, attr, fn):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    if name == "unchanged":
        def device_step(self, state, batch):
            loss, aux, _, _ = self._forward_backward(batch)
            return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
        patch(Trainer, "_device_step", device_step)
    elif name == "half_batch":
        forward_backward = Trainer._forward_backward

        def half(self, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return forward_backward(self, {k: v[:n] for k, v in batch.items()})
        patch(Trainer, "_forward_backward", half)
    elif name == "altered_answer":
        search, predict = FlatSearcher.search, ServingModel.predict

        def search_altered(self, queries, topk=10, return_items=True):
            out = search(self, queries, topk, return_items)
            out[0][0, 0] = (out[0][0, 0] + 1) % self.num_items
            return out

        def predict_altered(self, batch):
            out = predict(self, batch)
            out["logit"][0] += 0.5
            return out
        patch(FlatSearcher, "search", search_altered)
        patch(ServingModel, "predict", predict_altered)
    elif name == "no_exchange":
        def local_only(self):
            import torch
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(self.mesh.world_size)
        patch(Trainer, "_average_gradients", local_only)
    else:
        raise ValueError(f"fault {name!r}: one of {FAULTS}")
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
