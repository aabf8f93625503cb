#!/usr/bin/env python3
"""Interactive web viewer on a trained checkpoint, or GUI-attached training.

Port of scripts/gui.py (reference: scripts/gui.py:29-47): launch the viewer
process and a render loop over a checkpoint (``-d``), or train with the
viewer attached (``--train``, ``gui/trainer.py``). The viewer is the
built-in web viewer (``gui/web_viewer.py``): open the printed URL in a
browser and orbit with the mouse, or drive it over HTTP (``POST /camera``
with ``{"theta", "phi", "radius"}``, ``GET /frame.jpg``, ``GET /status``,
``POST /terminate``).

  python -m nerficg_torch.scripts.gui -d RUN_DIR [--port P] [--device cpu]
  python -m nerficg_torch.scripts.gui --train -c CONFIG [--port P] \
      [--device cpu] [KEY.SUBKEY=value ...]

It runs on the first CUDA card and refuses to start without one, unless
``--device cpu`` asks for the CPU (the kernels' plain versions). The viewer
process is spawned, and spawning imports this module again in the child:
the imports that reach ``torch`` and the methods stay inside the functions.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

__all__ = ['checkpoint_runner', 'train_with_gui', 'main']


def checkpoint_runner(run_dir: Path, port: int, device: str = 'cuda') -> None:
    """Render loop over a run dir's final checkpoint (reference:
    ICGui.Backend.CheckpointRunner): the current pose, again and again,
    until the viewer closes or posts ``/terminate``."""
    from nerficg_torch.core.logging import Logger
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.core.setup import resolve_device, setup, teardown
    from nerficg_torch.gui.state import LaunchConfig
    from nerficg_torch.gui.trainer import FPSRollingAverage, GuiTrainerMixin
    from nerficg_torch.gui.web_viewer import launch_gui_process

    resolve_device(device)          # no card: refuse before the spawn
    # The viewer first, so the page is reachable while the model loads.
    state, process = launch_gui_process(LaunchConfig(port=port))
    Logger.info(f'viewer at http://127.0.0.1:{port} (ctrl-c to exit)')
    ctx = setup(run_dir / 'training_config.yaml', device=device)
    ctx.config.GLOBAL.DATASET_TYPE = ctx.config.GLOBAL.DATASET_TYPE or 'Empty'
    try:
        dataset = Datasets.get_dataset(ctx.config)
    except Exception as exc:       # the run's data need not travel with it
        Logger.warning(f'dataset unavailable ({exc}); viewing with the '
                       'Empty dataset')
        dataset = Datasets.get_dataset(ctx.config, name='Empty')
    model = Methods.get_model(
        ctx.config, checkpoint=str(run_dir / 'checkpoints' / 'final.ckpt'),
        device=ctx.device)
    renderer = Methods.get_renderer(ctx.config, model)
    fps = FPSRollingAverage()
    mixin = GuiTrainerMixin()
    view = dataset.subsets['train'][0].to_simple() \
        if dataset.subsets['train'] else None
    try:
        while process.is_alive() and not state.terminate_training:
            pose = state['view']
            if pose is not None:
                view = mixin._pose_to_view(pose, dataset)
            if view is None:
                time.sleep(0.1)
                continue
            out = renderer.render_image(view)
            state.push_frame(out['rgb'].cpu().numpy())
            state['fps'] = fps.tick()
    except KeyboardInterrupt:
        pass
    process.terminate()
    process.join(timeout=10)
    teardown(ctx)


def train_with_gui(config: str, overrides: list[str], port: int,
                   device: str = 'cuda'):
    """The config's method trainer with the viewer attached; returns the
    trainer after its run."""
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.core.setup import setup, teardown
    from nerficg_torch.gui.trainer import with_gui

    ctx = setup(config, overrides, device=device)
    entry = Methods.get_entry(ctx.config.GLOBAL.METHOD_TYPE)
    model = Methods.get_model(ctx.config, device=ctx.device)
    renderer = entry.renderer_cls(ctx.config, model)
    trainer = with_gui(entry.trainer_cls)(ctx.config, model, renderer)
    trainer.GUI_PORT = port
    trainer.run(Datasets.get_dataset(ctx.config))
    teardown(ctx)
    return trainer


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description='interactive web viewer')
    parser.add_argument('-d', '--run-dir', default=None,
                        help='trained output dir (checkpoint viewing)')
    parser.add_argument('-c', '--config', default=None,
                        help='config for GUI-attached training (--train)')
    parser.add_argument('--train', action='store_true')
    parser.add_argument('--port', type=int, default=8642)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    parser.add_argument('overrides', nargs='*', default=[])
    args = parser.parse_args(argv)
    if args.train:
        return train_with_gui(args.config, args.overrides, args.port,
                              args.device)
    if args.run_dir:
        return checkpoint_runner(Path(args.run_dir), args.port, args.device)
    parser.error('provide --run-dir (view a checkpoint) or --train -c cfg')


if __name__ == '__main__':
    main()
