"""Quick probes to place round-4 golden grids (throwaway harness):
recalled-BG1 waterfall position and standard-mapping 16APSK waterfall.

Run: python experiments/probe_r4.py
"""
import time


def main():
    from ecc_ldpc_tpu.compile_cache import enable_compile_cache
    from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec, run_sweep
    from ecc_ldpc_tpu.sim.report import format_table

    enable_compile_cache()

    probes = [
        SweepSpec(code="nr5g/bg1/384", decoder="layered/norm:0.8125/25",
                  ebn0_db=(0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8), batch=1024,
                  seed=41,
                  stopping=StoppingRule(min_frame_errors=50,
                                        max_frames=4096)),
        SweepSpec(code="dvbs2/16200/12", decoder="layered/norm:0.8125/25",
                  channel="apsk16:r56:il",
                  ebn0_db=(2.6, 3.0, 3.2, 3.4, 3.6, 3.8), batch=1024,
                  seed=41,
                  stopping=StoppingRule(min_frame_errors=50,
                                        max_frames=4096)),
    ]
    for sw in probes:
        t0 = time.time()
        res = run_sweep(sw)
        print(f"{sw.code} {sw.channel}: {time.time()-t0:.0f}s", flush=True)
        print(format_table(res), flush=True)


if __name__ == "__main__":
    main()
