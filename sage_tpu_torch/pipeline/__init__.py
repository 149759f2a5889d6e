"""Pipeline orchestration: config, runner, output writers."""
