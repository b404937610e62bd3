from repro_torch.serving.engine import (EngineState, Request,  # noqa: F401
                                        Result, ServeEngine)
from repro_torch.serving.frontend import AsyncServeFrontend  # noqa: F401
from repro_torch.serving.page_pool import (PagePool,  # noqa: F401
                                           PagePoolError, PrefixCache,
                                           prefix_page_keys)
from repro_torch.serving.state_arena import (StateArena,  # noqa: F401
                                             StateArenaError)
from repro_torch.serving.scheduler import (CoverageScheduler,  # noqa: F401
                                           FifoScheduler, NewWork,
                                           RoundWork, Scheduler,
                                           SchedulerContext, make_scheduler)
from repro_torch.serving.traffic import (ARRIVALS,  # noqa: F401
                                         RequestTrace, bursty_arrivals,
                                         drive_open_loop, poisson_arrivals,
                                         run_open_loop, slo_metrics)
