from repro_torch.kernels.ssm_scan.ops import scan_lanes, ssm_scan, ssm_scan_ref

__all__ = ["scan_lanes", "ssm_scan", "ssm_scan_ref"]
