"""Gradio demo of the port on the card.

    python -m trajectorycrafter_tpu_torch.scripts.gradio_app [--port 12345] [CLI flags]

The port's counterpart of the root ``gradio_app.py``: one page with a video
upload, stride / center_scale / steps / seed controls, the pan / orbit /
zoom preset buttons (``TRAJ_PRESETS``), a Customize mode showing trajectory
examples, and a queued generate action (``run_pipeline``: one
``infer_gradual`` toward the pose into a timestamped run directory) that
returns the side-by-side viz video.  ``gradio`` is imported in
``build_app`` only, so the module imports without it; serving needs it
installed.  The app serves from one process: it refuses
``--mesh_dp/--mesh_sp/--mesh_tp`` before it builds anything.
"""

from __future__ import annotations

import os
from datetime import datetime

from trajectorycrafter_tpu_torch.cli import config_from_args, get_parser, require_card
from trajectorycrafter_tpu_torch.config import TrajCrafterConfig
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter

MAX_SEED = 2**31

# preset poses "theta; phi; r; x; y"
TRAJ_PRESETS = {
    "Orbit Left": "0; -30; 0; 0; 0",
    "Orbit Right": "0; 30; 0; 0; 0",
    "Orbit Up": "30; 0; 0; 0; 0",
    "Orbit Down": "-20; 0; 0; 0; 0",
    "Pan Left": "0; 0; 0; -2; 0",
    "Pan Right": "0; 0; 0; 2; 0",
    "Pan Up": "0; 0; 0; 0; 2",
    "Pan Down": "0; 0; 0; 0; -2",
    "Zoom in": "0; 0; 0.5; 0; 0",
    "Zoom out": "0; 0; -0.5; 0; 0",
}

# custom trajectory examples
TRAJ_EXAMPLES = [
    ["0; -30; 0.5; -2; 0"],
    ["0; 30; -0.4; 2; 0"],
    ["20; 40; 0.5; 2; 0"],
    ["0; -50; 0.3; 0; 0"],
    ["0; -35; 0.4; 0; 0"],
]

VIDEO_EXAMPLES = [
    [p, 2, 1, pose, 50, 43]
    for p, pose in zip(
        (
            "test/videos/0-NNvgaTcVzAG0-r.mp4",
            "test/videos/tUfDESZsQFhdDW9S.mp4",
            "test/videos/part-2-3.mp4",
            "test/videos/p7.mp4",
            "test/videos/synth.mp4",
        ),
        (e[0] for e in TRAJ_EXAMPLES),
    )
]

CSS = """
#input_video {max-width: 1024px !important}
#output_vid {max-width: 1024px; max-height: 576px}
.generate-btn {font-weight: bold !important}
"""


def run_pipeline(video_path, stride, center_scale, pose_str, steps, seed,
                 cfg: TrajCrafterConfig, tc: TrajCrafter) -> str:
    """One generation toward ``pose_str`` ("theta; phi; r; x; y", commas
    allowed) into a fresh ``run_<time>`` directory -> the path of its viz.mp4."""
    theta, phi, r, x, y = [float(v) for v in pose_str.replace(",", ";").split(";")]
    run_dir = os.path.join(cfg.save_dir, datetime.now().strftime("run_%Y%m%d_%H%M%S"))
    cfg.video_path = video_path
    cfg.stride = int(stride)
    cfg.seed = int(seed)
    cfg.render.radius_scale = float(center_scale)
    cfg.render.camera = "target"
    cfg.render.target_pose = (theta, phi, r, x, y)
    cfg.diffusion.num_inference_steps = int(steps)
    prev = cfg.save_dir
    cfg.save_dir = run_dir
    try:
        tc.infer_gradual()
    finally:
        cfg.save_dir = prev
    return os.path.join(run_dir, "viz.mp4")


def build_app(cfg: TrajCrafterConfig):
    import gradio as gr

    tc = TrajCrafter(cfg)

    def show_traj(mode):
        """A preset fills the pose box; Customize also shows the examples;
        Reset hides both."""
        if mode in TRAJ_PRESETS:
            return (gr.update(value=TRAJ_PRESETS[mode], visible=True),
                    gr.update(visible=False))
        if mode == "Customize":
            return (gr.update(value="0; 0; 0; 0; 0", visible=True),
                    gr.update(visible=True))
        return (gr.update(value="0; 0; 0; 0; 0", visible=False),
                gr.update(visible=False))

    with gr.Blocks(analytics_enabled=False, css=CSS,
                   title="TrajectoryCrafter (PyTorch)") as demo:
        gr.Markdown(
            "<div align='center'><h1>TrajectoryCrafter: Redirecting View Trajectory for "
            "Monocular Videos via Diffusion Models</h1><p>PyTorch pipeline on CUDA</p></div>")
        with gr.Row(equal_height=True):
            with gr.Column():
                input_video = gr.Video(label="Input Video", elem_id="input_video", format="mp4")
            with gr.Column():
                output_video = gr.Video(label="Generated Video", elem_id="output_vid",
                                        autoplay=True)
        with gr.Row():
            with gr.Row():
                stride = gr.Slider(minimum=1, maximum=3, step=1, label="Stride", value=1)
                center_scale = gr.Slider(minimum=0.1, maximum=2, step=0.1,
                                         label="center_scale", value=1)
                steps = gr.Slider(minimum=1, maximum=50, step=1, label="Sampling steps",
                                  value=50)
                seed = gr.Slider(label="Random seed", minimum=0, maximum=MAX_SEED, step=1,
                                 value=43)
            with gr.Row():
                pan_buttons = [gr.Button(value=f"Pan {d}") for d in ("Left", "Right", "Up", "Down")]
            with gr.Row():
                orbit_buttons = [gr.Button(value=f"Orbit {d}")
                                 for d in ("Left", "Right", "Up", "Down")]
            with gr.Row():
                other_buttons = [gr.Button(value=v)
                                 for v in ("Zoom in", "Zoom out", "Customize", "Reset")]
            with gr.Column():
                pose = gr.Text(value="0; 0; 0; 0; 0", visible=False,
                               label="Target camera pose (theta, phi, r, x, y)")
                with gr.Column(visible=False) as traj_egs:
                    gr.Markdown("Customize the pose as 'theta; phi; r; x; y' or pick an "
                                "example:")
                    gr.Examples(examples=TRAJ_EXAMPLES, inputs=[pose])
            with gr.Column():
                go = gr.Button("Generate video", variant="primary", elem_classes="generate-btn")

        for btn in pan_buttons + orbit_buttons + other_buttons:
            btn.click(inputs=[btn], outputs=[pose, traj_egs], fn=show_traj)

        go.click(inputs=[input_video, stride, center_scale, pose, steps, seed],
                 outputs=[output_video],
                 fn=lambda v, st, cs, p, n, sd: run_pipeline(v, st, cs, p, n, sd, cfg, tc))
        examples = [e for e in VIDEO_EXAMPLES if os.path.exists(e[0])]
        if examples:
            gr.Examples(examples=examples,
                        inputs=[input_video, stride, center_scale, pose, steps, seed])
    return demo


def main(argv=None):
    parser = get_parser()
    parser.add_argument("--port", type=int, default=12345)
    args = parser.parse_args(argv)
    if args.mesh_dp * args.mesh_sp * args.mesh_tp > 1:
        raise SystemExit(
            "error: the Gradio app serves from one process and takes no --mesh_dp/--mesh_sp/"
            "--mesh_tp: a sharded run needs every rank in step, which a queue of web "
            "requests on one process does not give; run cli.py or a script of scripts/ "
            "under torchrun for a sharded run")
    require_card()
    args.video_path = args.video_path or "unused"
    cfg = config_from_args(args)
    # one experiment directory per launch
    cfg.save_dir = os.path.join(cfg.save_dir, "gradio_" + datetime.now().strftime("%Y%m%d_%H%M"))
    os.makedirs(cfg.save_dir, exist_ok=True)
    app = build_app(cfg)
    app.queue(max_size=10)
    app.launch(server_name=args.server_name or "0.0.0.0", server_port=args.port, max_threads=10)


if __name__ == "__main__":
    main()
