"""The measurement probes on the card: the port of bench_scripts/'s Pallas
probes (scan_probe, stream_variants, k2_bisect, revolve_probe, pallas_probe,
kernel_feasibility), each runnable as python -m dlrm_tpu_torch.probes.<name>.
"""
