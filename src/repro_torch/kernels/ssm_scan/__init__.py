from repro_torch.kernels.ssm_scan.ops import (SSMScanFn, scan_lanes, ssm_scan,
                                              ssm_scan_bwd, ssm_scan_bwd_ref,
                                              ssm_scan_ref)

__all__ = ["SSMScanFn", "scan_lanes", "ssm_scan", "ssm_scan_bwd",
           "ssm_scan_bwd_ref", "ssm_scan_ref"]
