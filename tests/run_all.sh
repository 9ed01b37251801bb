#!/bin/sh
# Test runner on the CPU backend with 8 virtual devices (the flag must be
# set before the interpreter starts — see tests/conftest.py).
#
#   tests/run_all.sh          fast tier (-m "not slow")
#   tests/run_all.sh --all    full suite incl. slow equivalence tests
#   tests/run_all.sh <args>   extra pytest args pass through
DIR="$(dirname "$0")"
RUN="env JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -m pytest"
MARK='not slow'
if [ "$1" = "--all" ]; then
    MARK=''
    shift
fi
exec $RUN "$DIR" -q ${MARK:+-m "$MARK"} "$@"
