"""SSL training loop (counterpart of ``m3l_tpu/train/trainer.py``).

Epoch fit and validation loops, gradient accumulation and clipping (``optax.MultiSteps`` and
``clip_by_global_norm`` semantics, :class:`.optim.GradientChain`), the module's lr / wd
schedules, ``last.ckpt`` every epoch with periodic ``epoch-%04d.ckpt`` and log-spaced
trainable-only ``task-%04d.ckpt``, resume from ``last.ckpt``, and a save on SIGTERM / SIGUSR1.

The JAX step is one ``nnx.jit`` program; here it is eager: the module's loss, ``backward``, the
optimizer step and the module's post-update hook, on an explicit device (the card by default).
Randomness comes from a ``torch.Generator`` on that device, seeded from ``seed``; validation
batch i always uses the generator seeded from (seed, i), so validation numbers are comparable
across epochs. A ``torch.profiler`` trace covers the steps of ``profile_steps`` when
``profile_dir`` is set, with the program's spans (``utils/trace.py``) of the same steps on a
track of their own: ``trainer.place`` (the batch to the device), ``trainer.step`` (its ident the
global step) and its children ``trainer.forward``, ``trainer.backward``, ``trainer.optimizer``
and ``trainer.post`` (the module's post-update hook), and the loader's ``data.batch``.

With ``mesh`` (``train/mesh.py``) :meth:`fit` computes the single-process result on the global
batch, as JAX's GSPMD Trainer does: it shards the module (``shard_module``) before
``configure_optimizer``, every rank loads the same global batch and keeps its dp rows (JAX's
``_place``), the module draws its noise or masks for the global batch and keeps the same rows,
takes its batch statistics (centers, Sinkhorn-Knopp, KoLeo, masked counts) over the dp group, and
returns its loss and every scalar of its aux as this rank's share of the global value; the
optimizer sums the gradients over the dp group, the logged values are the shares summed over the
ranks, and rank 0 alone writes the checkpoints (in the single-process layout, teachers and centers
included, so a mesh run resumes from a single-process one and the reverse). A module takes a mesh
through :meth:`~..ssl.module.SSLModule.use_mesh`: every SSL family and every downstream task module
(the probes, the force field, the geometric force field). Under a mesh no preemption handler is installed (a save is collective and cannot run
inside a signal handler) and no reconstruction images are logged.
"""
from __future__ import annotations

import os
import signal
import time
from typing import TYPE_CHECKING, Iterable, Optional

import numpy as np
import torch

from ..utils import trace
from ..utils.device import resolve_device
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .mesh import gather_state, is_main, put_batch, shard_module, shard_state

if TYPE_CHECKING:  # ssl.module imports train.optim: a run-time import here would be circular
    from ..ssl.module import SSLModule


class Trainer:
    def __init__(
        self,
        *,
        max_epochs: int = 100,
        grad_accum_steps: int = 1,
        clip_gradients: Optional[float] = None,
        val_every_n_epochs: int = 1,
        ckpt_dir: Optional[str] = None,
        save_ckpt_every_n_epochs: int = 10,
        num_task_checkpoints: int = 0,
        log_every_n_steps: int = 50,
        log_images_every_n_epochs: int = 10,
        mesh=None,
        seed: int = 0,
        verbose: int = 1,
        profile_dir: Optional[str] = None,
        profile_steps: tuple[int, int] = (10, 15),
        logger=None,
        device: str | torch.device | None = "cuda",
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.max_epochs = max_epochs
        self.grad_accum_steps = grad_accum_steps
        self.clip_gradients = clip_gradients
        self.val_every_n_epochs = val_every_n_epochs
        self.ckpt_dir = ckpt_dir
        self.save_every = save_ckpt_every_n_epochs
        self.log_every = log_every_n_steps
        self.verbose = verbose if is_main(mesh) else 0  # rank 0 alone prints and logs
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.logger = logger if is_main(mesh) else None
        self.log_images_every = log_images_every_n_epochs
        self.global_step = 0
        self.current_epoch = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._val_seed = seed + 0x5EED
        self._preempted = False
        # log-spaced task checkpoints
        self.task_ckpt_epochs = (
            sorted(set(np.geomspace(1, max_epochs, num_task_checkpoints).astype(int).tolist())) if num_task_checkpoints else []
        )

    # ------------------------------------------------------------------ #
    def _install_signal_handlers(self, module, optimizer):
        def handler(signum, frame):
            self._preempted = True
            if self.verbose:
                print(f"[trainer] caught signal {signum}; saving last.ckpt and stopping")
            self._save(module, optimizer, "last.ckpt")

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass  # not in the main thread

    def _save(self, module: SSLModule, optimizer, name: str, trainable_only: bool = False):
        if self.ckpt_dir is None:
            return
        state = gather_state(module, self.mesh)  # collective under a mesh; None off rank 0
        opt_state = None if trainable_only else optimizer.state_dict()
        if not is_main(self.mesh):
            return
        if trainable_only:
            # task checkpoints keep only what the optimizer trains
            payload = {"model": {k: state[k] for k in module.trainable_parameters()}}
        else:
            payload = {"model": state, "opt": opt_state}
        payload.update(global_step=self.global_step, current_epoch=self.current_epoch)
        save_checkpoint(os.path.join(self.ckpt_dir, name), payload)

    def _try_resume(self, module: SSLModule, optimizer) -> bool:
        if self.ckpt_dir is None:
            return False
        last = latest_checkpoint(self.ckpt_dir)
        if last is None:
            return False
        payload = load_checkpoint(last, map_location=self.device)
        module.load_state_dict(shard_state(payload["model"], module, self.mesh))
        optimizer.load_state_dict(payload["opt"])
        self.global_step = int(payload["global_step"])
        self.current_epoch = int(payload["current_epoch"])
        if self.verbose:
            print(f"[trainer] resumed from {last} (epoch {self.current_epoch}, step {self.global_step})")
        return True

    def _place(self, batch: dict) -> dict:
        """The batch on the device; under a mesh this rank's dp rows of it."""
        with trace.span("trainer.place"):
            return put_batch({k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}, self.mesh)

    def _global(self, loss: torch.Tensor, scalars: dict) -> tuple[torch.Tensor, dict]:
        """Under a mesh, the global values of this rank's loss and scalar shares (one collective):
        every scalar of a module's aux is a share, a temperature too."""
        if self.mesh is None:
            return loss, scalars
        vals = self.mesh.global_mean(torch.stack([loss, *scalars.values()]))
        return vals[0], dict(zip(scalars, vals[1:]))

    def _val_generator(self, index: int) -> torch.Generator:
        """The generator of validation batch ``index``: the same in every epoch."""
        return torch.Generator(device=self.device).manual_seed((self._val_seed << 20) + index)

    @staticmethod
    def _scalars(aux: dict) -> dict:
        return {k: v.detach() for k, v in aux.items() if torch.is_tensor(v) and v.dim() == 0}

    def train_step(self, module: SSLModule, optimizer, batch: dict) -> tuple[torch.Tensor, dict]:
        """Loss, gradients, one optimizer call and the module's post-update hook for one batch
        already on the device; returns the loss and the scalar aux values, on the device."""
        with trace.span("trainer.step", self.global_step):
            with trace.span("trainer.forward"):
                loss, aux = module.training_loss(batch, self.generator, self.global_step)
            with trace.span("trainer.backward"):
                loss.backward()
            with trace.span("trainer.optimizer"):
                optimizer.step()
                optimizer.zero_grad()
            with trace.span("trainer.post"):
                module.on_train_batch_end(aux, self.global_step)
            return self._global(loss.detach(), self._scalars(aux))

    # ------------------------------------------------------------------ #
    def fit(
        self,
        module: SSLModule,
        train_loader: Iterable,
        val_loader: Optional[Iterable] = None,
        steps_per_epoch: Optional[int] = None,
    ):
        steps_per_epoch = steps_per_epoch or len(train_loader)
        if self.mesh is not None:
            module.use_mesh(self.mesh)
        module.to(self.device)
        if hasattr(module, "setup_schedules"):
            module.setup_schedules(steps_per_epoch, self.max_epochs)
        if self.mesh is not None:  # sharded before the optimizer is built, as JAX's Trainer does
            shard_module(module, self.mesh)
        optimizer = module.configure_optimizer(steps_per_epoch, self.max_epochs)
        optimizer.set_mesh(self.mesh)
        if self.clip_gradients is not None:
            optimizer.clip_norms = (self.clip_gradients, *optimizer.clip_norms)
        optimizer.every_k = self.grad_accum_steps
        self._try_resume(module, optimizer)
        if self.mesh is None:
            self._install_signal_handlers(module, optimizer)

        history = []
        profiler = None
        while self.current_epoch < self.max_epochs and not self._preempted:
            t0 = time.time()
            epoch_losses = []
            epoch_scalars: dict = {}
            for batch in train_loader:
                if self._preempted:
                    break
                batch = self._place(batch)
                if self.profile_dir and self.global_step == self.profile_steps[0]:
                    profiler = self._start_profiler()
                loss, scalars = self.train_step(module, optimizer, batch)
                if profiler is not None and self.global_step == self.profile_steps[1]:
                    self._stop_profiler(profiler)
                    profiler = None
                self.global_step += 1
                if self.global_step % self.log_every == 0:
                    vals = {kk: float(vv) for kk, vv in scalars.items()}
                    if self.logger is not None:
                        self.logger.log_scalars({f"train/{kk}": vv for kk, vv in vals.items()}, self.global_step)
                    if self.verbose:
                        print(f"[trainer] epoch {self.current_epoch} step {self.global_step}: " + " ".join(f"{kk}={vv:.4f}" for kk, vv in vals.items()))
                # device scalars; one stack, mean and readback at the epoch's end
                epoch_losses.append(loss)
                for kk, vv in scalars.items():
                    epoch_scalars.setdefault(kk, []).append(vv)
            epoch_loss = torch.stack(epoch_losses).mean().item() if epoch_losses else float("nan")
            train_scalars = {f"train_{kk}": torch.stack(vv).mean().item() for kk, vv in epoch_scalars.items()}

            val_loss = None
            if val_loader is not None and (self.current_epoch + 1) % self.val_every_n_epochs == 0:
                val_loss = self._validate(module, val_loader)
            self._maybe_log_images(module, train_loader, val_loader)

            self.current_epoch += 1
            history.append({"epoch": self.current_epoch, "train_loss": epoch_loss, "val_loss": val_loss, "time": time.time() - t0, **train_scalars})
            if self.verbose:
                print(f"[trainer] epoch {self.current_epoch}/{self.max_epochs} train_loss={epoch_loss:.4f}" + (f" val_loss={val_loss:.4f}" if val_loss is not None else ""))
            self._save(module, optimizer, "last.ckpt")
            if self.save_every and self.current_epoch % self.save_every == 0:
                self._save(module, optimizer, f"epoch-{self.current_epoch:04d}.ckpt")
            if self.current_epoch in self.task_ckpt_epochs:
                self._save(module, optimizer, f"task-{self.current_epoch:04d}.ckpt", trainable_only=True)
        if profiler is not None:
            self._stop_profiler(profiler)
        return history

    @torch.no_grad()
    def _validate(self, module: SSLModule, val_loader: Iterable) -> Optional[float]:
        losses, scalars = [], {}
        for bi, batch in enumerate(val_loader):
            loss, aux = module.validation_loss(self._place(batch), self._val_generator(bi), self.global_step)
            loss, aux = self._global(loss, self._scalars(aux))
            losses.append(loss)
            for kk, vv in aux.items():
                scalars.setdefault(kk, []).append(float(vv))
        if self.logger is not None and scalars:
            self.logger.log_scalars({f"val/{kk}": float(np.mean(vv)) for kk, vv in scalars.items()}, self.global_step)
        return torch.stack(losses).mean().item() if losses else None

    def _maybe_log_images(self, module, train_loader, val_loader) -> None:
        """Masked-reconstruction images to a logger that has ``log_image``, from modules that
        provide ``reconstruction_images(batch, generator) -> {name: (H, W, C)}``."""
        if (
            self.logger is None
            or self.mesh is not None
            or not hasattr(self.logger, "log_image")
            or not hasattr(module, "reconstruction_images")
            or not self.log_images_every
            or (self.current_epoch + 1) % self.log_images_every != 0
        ):
            return
        loader = val_loader if val_loader is not None else train_loader
        try:
            batch = next(iter(loader))
        except StopIteration:
            return
        generator = torch.Generator(device=self.device).manual_seed(self._val_seed)
        imgs = module.reconstruction_images(self._place(batch), generator)
        for name, img in imgs.items():
            self.logger.log_image(f"reconstruction/{name}", np.clip(img.float().cpu().numpy(), 0.0, 1.0), self.global_step)

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        trace.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        spans = trace.stop()
        profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_step{self.global_step}.json")
        profiler.export_chrome_trace(path)
        trace.add_to_chrome_trace(path, spans)
