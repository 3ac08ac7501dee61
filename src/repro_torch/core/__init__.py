"""SiPipe core: the paper's contribution as composable modules.

Host modules (sampler, tsem, sat, bic, scheduler, policies, sequence,
request, sampling_params) are copies of ``repro.core``'s with only their
import paths changed; ``engine`` is the port of the serving engine.
"""
