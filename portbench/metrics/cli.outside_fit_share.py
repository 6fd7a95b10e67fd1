"""cli.outside_fit_share (%): the share of the window's `cli.main` calls
spent outside `fit_mmctm_restarts` (reading the TSVs, formatting, writing
the tables), from the harness's spans around both."""


def read(run):
    if run["traffic"]["entry"] != "cli":
        return None
    cli_s = sum(run["fit_walls"])
    return 100.0 * (cli_s - run["restarts_s"]) / cli_s
