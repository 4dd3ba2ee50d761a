#!/usr/bin/env python3
"""Runs some of chip_smoke.py's phases on one GPU, after building the kernels.

    python3 tools/run_smoke_phases.py kernels-sd3-chroma reference-sd3 ...

Phases: kernels-sd3-chroma, reference-sd3, reference-chroma, slice-sd3-lora,
slice-chroma-lora, driver-sd3, driver-chroma (with the vae phase first,
whose Flux VAE Chroma's driver reads), kernels-qwen, reference-qwen,
slice-qwen-image-lora, slice-qwen-image-edit-lora, qwen25vl, driver-qwen,
kernels-flux2-auraflow, reference-flux2, reference-auraflow, slice-flux2-lora,
slice-flux2-edit-lora, slice-auraflow-lora, mistral3, pile-t5, driver-flux2,
driver-auraflow, kernels-lumina, reference-lumina2, reference-zimage,
reference-omnigen2, slice-lumina2-lokr, slice-omnigen2-lora, driver-lumina2,
driver-zimage (the last two with the vae phase first, whose Flux VAE they
read), kernels-hidream, reference-hidream, llama31, slice-hidream-lora,
driver-hidream (with the vae phase first), kernels-cosmos, reference-cosmos,
qwen3-0.6b, cosmos-tokenizer, slice-anima-lora, slice-cosmos1-lora,
driver-anima, driver-predict2 (each with the wan-vae phase first, whose Wan
2.1 VAE it reads),
driver-cosmos (with the cosmos-tokenizer phase first, whose checkpoint it
reads), kernels-hunyuan, reference-hunyuan-video, reference-hunyuan-image,
hunyuan-vae, llava-llama3, byt5, slice-hunyuan-video-lora,
slice-hunyuan-image-lora, driver-hunyuan-video (with the hunyuan-vae phase
first, whose VAE it reads), driver-hunyuan-image, and `hunyuan`: the
last ten, hunyuan-vae run by driver-hunyuan-video; kernels-ltx-hv15,
reference-hunyuan-video-15, reference-ltx-video, reference-ltx2, ltx-vae,
gemma3-12b, slice-hunyuan-video-15-lora, slice-ltx-video-lora,
slice-ltx2-lora, driver-hunyuan-video-15, driver-ltx-video and driver-ltx2
(the last two with the ltx-vae phase first, whose VAE they read), and
`ltx-hv15`: these twelve, ltx-vae run once. Each prints its JSON
lines as in the whole smoke, and a last line its seconds; a failed check
exits non-zero.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv):
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("run_smoke_phases: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ltx_vae = {}  # the ltx-vae phase's folder, once made
    phases = {
        "kernels-sd3-chroma": cs.phase_kernels_sd3_chroma,
        "reference-sd3": cs.phase_reference_sd3,
        "reference-chroma": cs.phase_reference_chroma,
        "slice-sd3-lora": lambda: cs.phase_slice_family(
            "slice-sd3-lora", "sd3-medium-lora-1024", cs.build_sd3_slice),
        "slice-chroma-lora": lambda: cs.phase_slice_family(
            "slice-chroma-lora", "chroma-lora-512", cs.build_chroma_slice),
        "driver-sd3": lambda: cs.phase_driver_family("sd3"),
        "driver-chroma": lambda: cs.phase_driver_family("chroma", cs.phase_vae()),
        "kernels-qwen": cs.phase_kernels_qwen,
        "reference-qwen": cs.phase_reference_qwen,
        "slice-qwen-image-lora": cs.phase_slice_qwen,
        "slice-qwen-image-edit-lora": lambda: cs.phase_slice_qwen(edit=True),
        "qwen25vl": cs.phase_qwen25vl,
        "driver-qwen": cs.phase_driver_qwen,
        "kernels-flux2-auraflow": lambda: cs.phase_kernels_flux2_auraflow(ptxas),
        "reference-flux2": cs.phase_reference_flux2,
        "reference-auraflow": cs.phase_reference_auraflow,
        "slice-flux2-lora": cs.phase_slice_flux2,
        "slice-flux2-edit-lora": lambda: cs.phase_slice_flux2(edit=True),
        "slice-auraflow-lora": cs.phase_slice_auraflow,
        "mistral3": cs.phase_mistral3,
        "pile-t5": cs.phase_pile_t5,
        "driver-flux2": lambda: cs.phase_driver_family("flux2"),
        "driver-auraflow": lambda: cs.phase_driver_family("auraflow"),
        "kernels-lumina": lambda: cs.phase_kernels_lumina(ptxas),
        "reference-lumina2": lambda: cs.phase_reference_lumina("lumina_2"),
        "reference-zimage": lambda: cs.phase_reference_lumina("z_image"),
        "reference-omnigen2": lambda: cs.phase_reference_lumina("omnigen2"),
        "slice-lumina2-lokr": lambda: cs.phase_slice_lumina("lumina_2"),
        "slice-omnigen2-lora": lambda: cs.phase_slice_lumina("omnigen2"),
        "driver-lumina2": lambda: cs.phase_driver_family("lumina_2", cs.phase_vae()),
        "driver-zimage": lambda: cs.phase_driver_family("z_image", cs.phase_vae()),
        "kernels-hidream": cs.phase_kernels_hidream,
        "reference-hidream": cs.phase_reference_hidream,
        "llama31": cs.phase_llama31,
        "slice-hidream-lora": cs.phase_slice_hidream,
        "driver-hidream": lambda: cs.phase_driver_family("hidream", cs.phase_vae()),
        "kernels-cosmos": cs.phase_kernels_cosmos,
        "reference-cosmos": cs.phase_reference_cosmos,
        "qwen3-0.6b": cs.phase_qwen3,
        "cosmos-tokenizer": cs.phase_cosmos_tokenizer,
        "slice-anima-lora": lambda: cs.phase_slice_cosmos("anima"),
        "slice-cosmos1-lora": lambda: cs.phase_slice_cosmos("cosmos"),
        "driver-anima": lambda: cs.phase_driver_family("anima", cs.phase_wan_vae()),
        "driver-predict2": lambda: cs.phase_driver_family("cosmos_predict2", cs.phase_wan_vae()),
        "driver-cosmos": lambda: cs.phase_driver_family("cosmos", cs.phase_cosmos_tokenizer()),
        "kernels-hunyuan": cs.phase_kernels_hunyuan,
        "reference-hunyuan-video": lambda: cs.phase_reference_hunyuan("hunyuan-video"),
        "reference-hunyuan-image": lambda: cs.phase_reference_hunyuan("hunyuan_image"),
        "hunyuan-vae": cs.phase_hunyuan_vae,
        "llava-llama3": cs.phase_llava_llama3,
        "byt5": cs.phase_byt5,
        "slice-hunyuan-video-lora": lambda: cs.phase_slice_hunyuan("hunyuan-video"),
        "slice-hunyuan-image-lora": lambda: cs.phase_slice_hunyuan("hunyuan_image"),
        "driver-hunyuan-video": lambda: cs.phase_driver_family("hunyuan-video",
                                                               cs.phase_hunyuan_vae()),
        "driver-hunyuan-image": lambda: cs.phase_driver_family("hunyuan_image"),
        "kernels-ltx-hv15": cs.phase_kernels_ltx_hv15,
        **{f"reference-{name}": (lambda f=fam: cs.phase_reference_ltx_hv15(f))
           for name, fam in (("hunyuan-video-15", "hunyuan_video_15"),
                             ("ltx-video", "ltx-video"), ("ltx2", "ltx2"))},
        "ltx-vae": lambda: ltx_vae.setdefault("path", cs.phase_ltx_vae()),
        "gemma3-12b": cs.phase_gemma3,
        **{cs.LTX_HV15_CELLS[fam][0]: (lambda f=fam: cs.phase_slice_ltx_hv15(f))
           for fam in cs.LTX_HV15_CELLS},
        "driver-hunyuan-video-15": lambda: cs.phase_driver_family("hunyuan_video_15"),
        "driver-ltx-video": lambda: cs.phase_driver_family(
            "ltx-video", ltx_vae.get("path") or ltx_vae.setdefault("path", cs.phase_ltx_vae())),
        "driver-ltx2": lambda: cs.phase_driver_family(
            "ltx2", ltx_vae.get("path") or ltx_vae.setdefault("path", cs.phase_ltx_vae())),
    }
    groups = {"hunyuan": ["kernels-hunyuan", "reference-hunyuan-video",
                          "reference-hunyuan-image", "llava-llama3", "byt5",
                          "slice-hunyuan-video-lora", "slice-hunyuan-image-lora",
                          "driver-hunyuan-video", "driver-hunyuan-image"],
              "ltx-hv15": ["kernels-ltx-hv15", "reference-hunyuan-video-15",
                           "reference-ltx-video", "reference-ltx2", "ltx-vae", "gemma3-12b",
                           "slice-hunyuan-video-15-lora", "slice-ltx-video-lora",
                           "slice-ltx2-lora", "driver-hunyuan-video-15", "driver-ltx-video",
                           "driver-ltx2"]}
    argv = [p for name in argv for p in groups.get(name, [name])]
    unknown = [p for p in argv if p not in phases]
    if unknown:
        print(f"run_smoke_phases: unknown phases {unknown}", file=sys.stderr)
        return 2
    cs.emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=cs.nvidia_smi_line())
    ptxas = cs.phase_build()
    t0 = cs.time.perf_counter()
    for name in argv:
        phases[name]()
        cs._free()
    cs.emit(phase="phases", names=argv, seconds=cs.time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
