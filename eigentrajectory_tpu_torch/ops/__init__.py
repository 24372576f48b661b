from .recon import (fused_recon_metrics, fused_recon_metrics_plain, fused_reconstruct,
                    fused_reconstruct_plain)
